"""Generate tests/data/reference_semantics_truth.json.

De-correlation fixture (VERDICT r4 item 8): the numbers in the fixture
are computed by THIS script, whose formulas are direct float64
transcriptions of the reference's C++ sources - cited per case below -
written without looking at either envutil or tests/oracle.py. The
test tier (tests/test_reference_truth.py) then checks the PRODUCT and
the ORACLE independently against the frozen literals, so a shared
misreading of a reference convention in both pipelines (the residual
risk VERDICT r4 flags for the golden tier) fails loudly against this
third transcription.

Transcribed semantics:
  * stepper edge-to-edge sample placement, doubled-int formulation
    (/root/reference/stepper.h:296-337):
      planar[i] = bias + (2i+1) * (a1/(2W)) + (2W-(2i+1)) * (a0/(2W))
      bias = bias_px * (a1-a0)/W
  * ll_to_ray   (geometry.h:152-233):  (sinlon*coslat, sinlat,
                                        coslon*coslat) as
                                        (RIGHT, DOWN, FORWARD)
  * ray_to_ll   (geometry.h:278-301):  lat = atan2(down,
                                        hypot(right, forward)),
                                        lon = atan2(right, forward)
  * rect_to_ray (geometry.h:363-386):  (h, v, 1)
  * ray_to_rect (geometry.h:327-360):  (right/forward, down/forward)
  * cyl_to_ray  (geometry.h:417-442):  (sin h, v, cos h)
  * ster_to_ray (geometry.h:481-512):  r = hypot(h, v),
      theta = 2*atan(r/2), phi = atan2(h, -v),
      (sin(theta)sin(phi), -sin(theta)cos(phi), cos(theta))
  * ray_to_ster (geometry.h:444-478):  normalize, f = 2/(forward+1),
      (right*f, down*f)
  * fish_to_ray (geometry.h:539-570):  r = hypot(h, v),
      phi = atan2(h, -v), (sin(r)sin(phi), -sin(r)cos(phi), cos(r))
  * ray_to_fish (geometry.h:514-537):  s = hypot(right, down),
      r = pi/2 - atan2(forward, s), phi = atan2(down, right),
      (r cos(phi), r sin(phi))
  * ir_to_ray   (geometry.h:663-790, sections LEFT=0 RIGHT=1 TOP=2
      BOTTOM=3 FRONT=4 BACK=5 per envutil_basic.h:56-64):
      centered in -> += (refc_md, 3*section_md); section = floor-div
      of y by section_md; in-face = crd - refc_md (y after section
      removal); per-section ray table as in the C++
  * ba6_to_ray  (geometry.h:~800): ir_to_ray with
      crd2 = tan(crd2 * pi/4) applied to the in-face coordinate

Run: python tools/gen_reference_truth.py (rewrites the fixture).
"""

import json
import math
import os

import numpy as np


def stepper_axis(n, a0, a1, bias_px, idx):
    out = []
    for i in idx:
        ll = 2 * i + 1
        v = (bias_px * (a1 - a0) / n
             + ll * (a1 / (2.0 * n))
             + (2 * n - ll) * (a0 / (2.0 * n)))
        out.append(v)
    return out


def ll_to_ray(lon, lat):
    return [math.sin(lon) * math.cos(lat), math.sin(lat),
            math.cos(lon) * math.cos(lat)]


def ray_to_ll(r, d, f):
    return [math.atan2(r, f), math.atan2(d, math.hypot(r, f))]


def rect_to_ray(h, v):
    return [h, v, 1.0]


def ray_to_rect(r, d, f):
    return [r / f, d / f]


def cyl_to_ray(h, v):
    return [math.sin(h), v, math.cos(h)]


def ster_to_ray(h, v):
    r = math.hypot(h, v)
    theta = 2.0 * math.atan(r / 2.0)
    phi = math.atan2(h, -v)
    return [math.sin(theta) * math.sin(phi),
            -math.sin(theta) * math.cos(phi), math.cos(theta)]


def ray_to_ster(r, d, f):
    n = 1.0 / math.sqrt(r * r + d * d + f * f)
    r, d, f = r * n, d * n, f * n
    fac = 2.0 / (f + 1.0)
    return [r * fac, d * fac]


def fish_to_ray(h, v):
    r = math.hypot(h, v)
    phi = math.atan2(h, -v)
    return [math.sin(r) * math.sin(phi),
            -math.sin(r) * math.cos(phi), math.cos(r)]


def ray_to_fish(r, d, f):
    s = math.hypot(r, d)
    rr = math.pi / 2.0 - math.atan2(f, s)
    phi = math.atan2(d, r)
    return [rr * math.cos(phi), rr * math.sin(phi)]


def ir_to_ray(px, py, section_md=2.0, refc_md=1.0, ba6=False):
    # centered -> ul-based
    x = px + refc_md
    y = py + 3.0 * section_md
    section = int(y // section_md)
    y -= section * section_md
    x -= refc_md
    y -= refc_md
    if ba6:
        x = math.tan(x * (math.pi / 4.0))
        y = math.tan(y * (math.pi / 4.0))
    # envutil_basic.h:56-64: LEFT RIGHT TOP BOTTOM FRONT BACK
    if section == 0:    # CM_LEFT
        return [-1.0, y, x]
    if section == 1:    # CM_RIGHT
        return [1.0, y, -x]
    if section == 2:    # CM_TOP
        return [-x, -1.0, -y]
    if section == 3:    # CM_BOTTOM
        return [-x, 1.0, y]
    if section == 4:    # CM_FRONT
        return [x, y, 1.0]
    return [-x, y, -1.0]  # CM_BACK


def main():
    cases = {}

    # --- stepper placement (stepper.h doubled-int edge-to-edge) -----
    cases["stepper_axis"] = []
    for (n, a0, a1, bias, idx) in [
            (1000, -math.pi, math.pi, 0.0, [0, 1, 499, 999]),
            (500, -math.pi / 2, math.pi / 2, 0.0, [0, 249, 499]),
            (1000, -math.pi, math.pi, 0.25, [0, 999]),
            # anisotropic non-symmetric extent (crop window)
            (640, -0.75, 1.25, 0.0, [0, 320, 639]),
    ]:
        cases["stepper_axis"].append(
            dict(n=n, a0=a0, a1=a1, bias=bias, idx=idx,
                 values=stepper_axis(n, a0, a1, bias, idx)))

    # --- planar -> ray ----------------------------------------------
    pts = [(0.0, 0.0), (0.3, -0.2), (-1.1, 0.7), (2.5, 1.2)]
    cases["ll_to_ray"] = [dict(p=list(p), ray=ll_to_ray(*p))
                          for p in pts]
    cases["rect_to_ray"] = [dict(p=list(p), ray=rect_to_ray(*p))
                            for p in pts]
    cases["cyl_to_ray"] = [dict(p=list(p), ray=cyl_to_ray(*p))
                           for p in pts]
    cases["ster_to_ray"] = [dict(p=list(p), ray=ster_to_ray(*p))
                            for p in pts]
    cases["fish_to_ray"] = [dict(p=list(p), ray=fish_to_ray(*p))
                            for p in pts]

    # --- ray -> planar ----------------------------------------------
    rays = [(0.1, -0.2, 0.9), (-0.5, 0.4, 0.7), (0.3, 0.9, 0.2),
            (0.0, 0.0, 1.0)]
    cases["ray_to_ll"] = [dict(ray=list(r), p=ray_to_ll(*r))
                          for r in rays]
    cases["ray_to_rect"] = [dict(ray=list(r), p=ray_to_rect(*r))
                            for r in rays]
    cases["ray_to_ster"] = [dict(ray=list(r), p=ray_to_ster(*r))
                            for r in rays]
    cases["ray_to_fish"] = [dict(ray=list(r), p=ray_to_fish(*r))
                            for r in rays]

    # --- cubemap IR / biatan6 planar -> ray (all six sections) ------
    cases["ir_to_ray"] = []
    cases["ba6_to_ray"] = []
    for sec in range(6):
        # centered IR y for section sec at in-face (fx, fy):
        # y_centered = (sec - 3) * section_md + refc_md + fy
        for (fx, fy) in [(0.0, 0.0), (0.37, -0.52), (-0.81, 0.64)]:
            py = (sec - 3) * 2.0 + 1.0 + fy
            px = fx
            cases["ir_to_ray"].append(
                dict(p=[px, py], sec=sec, f=[fx, fy],
                     ray=ir_to_ray(px, py)))
            cases["ba6_to_ray"].append(
                dict(p=[px, py], sec=sec, f=[fx, fy],
                     ray=ir_to_ray(px, py, ba6=True)))

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, "tests", "data",
                        "reference_semantics_truth.json")
    with open(path, "w") as fh:
        json.dump(cases, fh, indent=1)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
