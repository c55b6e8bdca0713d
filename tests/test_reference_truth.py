"""Third-transcription truth tier (VERDICT r4 item 8).

tests/data/reference_semantics_truth.json holds literal float64
expectations generated by tools/gen_reference_truth.py, whose formulas
are transcribed directly from the reference C++ (stepper.h:296-337
doubled-int edge-to-edge placement, geometry.h planar<->ray functors,
envutil_basic.h:56-64 face order) WITHOUT looking at either pipeline.

Both the product (envutil.core.geometry / models.stepper) and the
independent oracle (tests/oracle.py) must match the frozen literals -
a convention misread shared by product and oracle (the golden tier's
blind spot) fails here against the third transcription.
"""

import json
import os

import numpy as np
import pytest

import oracle as O

from envutil.core import geometry as G
from envutil.models import stepper as ST

TRUTH = json.load(open(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "data",
    "reference_semantics_truth.json")))

TOL = 1e-13


def _arr(p):
    return np.asarray(p, np.float64)


def test_stepper_axis_truth_product():
    for case in TRUTH["stepper_axis"]:
        got = ST.planar_axis(case["n"], case["a0"], case["a1"],
                             case["bias"], dtype=np.float64)
        got = got[np.asarray(case["idx"], int)]
        np.testing.assert_allclose(got, case["values"], rtol=0,
                                   atol=TOL)


def test_stepper_axis_truth_oracle():
    # the oracle's target_planar covers bias and full extents; its
    # formula px = bias*(x1-x0)/W + x0 + (2i+1)/(2W)*(x1-x0) must
    # land on the reference's doubled-int placement
    for case in TRUTH["stepper_axis"]:
        n, a0, a1, b = (case["n"], case["a0"], case["a1"],
                        case["bias"])
        i = np.asarray(case["idx"], np.float64)
        got = (b * (a1 - a0) / n + a0
               + (2 * i + 1) / (2 * n) * (a1 - a0))
        np.testing.assert_allclose(got, case["values"], rtol=0,
                                   atol=TOL)


def test_oracle_target_planar_matches_truth():
    # drive the oracle's actual grid builder on the spherical case
    case = TRUTH["stepper_axis"][0]
    gx, _gy, _e = O.target_planar(O.SPHERICAL, case["n"],
                                  case["n"] // 2, 2 * np.pi)
    got = gx[0, np.asarray(case["idx"], int)]
    np.testing.assert_allclose(got, case["values"], rtol=0, atol=TOL)


PLANAR_FNS = [
    ("ll_to_ray", G.ll_to_ray, O.SPHERICAL),
    ("rect_to_ray", G.rect_to_ray, O.RECTILINEAR),
    ("cyl_to_ray", G.cyl_to_ray, O.CYLINDRICAL),
    ("ster_to_ray", G.ster_to_ray, O.STEREOGRAPHIC),
    ("fish_to_ray", G.fish_to_ray, O.FISHEYE),
]


@pytest.mark.parametrize("key,fn,oprj", PLANAR_FNS,
                         ids=[k for k, _f, _o in PLANAR_FNS])
def test_planar_to_ray_truth(key, fn, oprj):
    for case in TRUTH[key]:
        px, py = case["p"]
        want = _arr(case["ray"])
        got = np.asarray(fn(np.float64(px), np.float64(py)),
                         np.float64)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7,
                                   err_msg=f"product {key}{case['p']}")
        oray = O.to_ray(oprj, np.asarray([px]), np.asarray([py]))[0]
        np.testing.assert_allclose(oray, want, rtol=0, atol=TOL,
                                   err_msg=f"oracle {key}{case['p']}")


RAY_FNS = [
    ("ray_to_ll", G.ray_to_ll, O.SPHERICAL),
    ("ray_to_rect", G.ray_to_rect, O.RECTILINEAR),
    ("ray_to_ster", G.ray_to_ster, O.STEREOGRAPHIC),
    ("ray_to_fish", G.ray_to_fish, O.FISHEYE),
]


@pytest.mark.parametrize("key,fn,oprj", RAY_FNS,
                         ids=[k for k, _f, _o in RAY_FNS])
def test_ray_to_planar_truth(key, fn, oprj):
    for case in TRUTH[key]:
        x, y, z = case["ray"]
        want = _arr(case["p"])
        got = np.asarray(fn(np.float64(x), np.float64(y),
                            np.float64(z)), np.float64)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7,
                                   err_msg=f"product {key}{case['ray']}")
        op = O.from_ray(oprj, _arr(case["ray"])[None])
        np.testing.assert_allclose(np.asarray(op).ravel(), want,
                                   rtol=0, atol=TOL,
                                   err_msg=f"oracle {key}{case['ray']}")


@pytest.mark.parametrize("key,ba6", [("ir_to_ray", False),
                                     ("ba6_to_ray", True)])
def test_cubemap_ir_truth(key, ba6):
    fn = G.ba6_to_ray if ba6 else G.ir_to_ray
    for case in TRUTH[key]:
        px, py = case["p"]
        want = _arr(case["ray"])
        got = np.asarray(fn(np.float64(px), np.float64(py)),
                         np.float64)
        np.testing.assert_allclose(
            got, want, rtol=0, atol=1e-7,
            err_msg=f"product {key}{case['p']}")
        # oracle: face + in-face planar through cubeface_ray (the
        # biatan6 tan is applied by the oracle's target_rays; apply
        # it here for the ba6 rows)
        fx, fy = case["f"]
        if ba6:
            fx = np.tan(fx * np.pi / 4.0)
            fy = np.tan(fy * np.pi / 4.0)
        oray = O.cubeface_ray(np.asarray([case["sec"]]),
                              np.asarray([fx]), np.asarray([fy]))[0]
        np.testing.assert_allclose(oray, want, rtol=0, atol=TOL,
                                   err_msg=f"oracle {key}{case['p']}")
