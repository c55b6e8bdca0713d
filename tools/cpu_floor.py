"""Measure the repo's own XLA-CPU rate on each BASELINE sweep config
as a *floor proxy* for the unbuildable reference binary (BASELINE.md:
no OpenImageIO in this image, so the reference cannot be compiled
here).

The XLA-CPU path vectorizes the same arithmetic the reference's SIMD
pipeline runs (coordinates + tensor-product spline evaluation +
synopsis) over the host cores, so its Mpix/s brackets the reference's
from below on the same machine class. These are CPU rates only: they
are never reported under a device's name.

Run: JAX_PLATFORMS=cpu python tools/cpu_floor.py [tags...]
Writes/updates CPU_FLOORS.json at the repo root (one entry per config
tag) and prints one JSON line per config.
"""

import json
import math
import os
import sys
import time


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import numpy as np

    from envutil.core.conventions import Projection
    from envutil.core.facet import Facet
    from envutil.core.metrics import get_extent, get_step
    from envutil.models import environment as E
    from envutil.models import cubemap as CBM
    from envutil.runtime.args import Args
    from envutil.runtime.render import _compiled_window, build_plan

    rng = np.random.default_rng(7)

    def sph_facet(w, h, degree):
        yy, xx = np.meshgrid(np.linspace(0, 1, h, dtype=np.float32),
                             np.linspace(0, 1, w, dtype=np.float32),
                             indexing="ij")
        img = np.stack([xx, yy, xx * yy], axis=-1)
        fct = Facet(facet_no=0, nchannels=3)
        fct.set_geometry(Projection.SPHERICAL, w, h, 2 * math.pi)
        fct.step = get_step(Projection.SPHERICAL, w, h, 2 * math.pi)
        fct.process_geometry()
        return fct, E.make_mount_source(fct, img, degree, degree)

    def cube_src(face_px=1024, projection=Projection.BIATAN6,
                 fov_deg=100.0):
        faces = np.stack([rng.random((face_px, face_px, 3),
                                     dtype=np.float32)
                          for _ in range(6)])
        cfct = Facet(facet_no=0, nchannels=3)
        cfct.set_geometry(projection, face_px, 6 * face_px,
                          math.radians(fov_deg))
        cfct.step = get_step(projection, face_px, 6 * face_px,
                             math.radians(fov_deg))
        cfct.process_geometry()
        return cfct, CBM.make_cubemap_source(cfct, faces, 3, 3, 128, 64)

    def rect_facets(n, hfov_deg, w, h, yaw_step, lens=False):
        fcts, srcs = [], []
        for i in range(n):
            f = Facet(facet_no=i, nchannels=3)
            f.set_geometry(Projection.RECTILINEAR, w, h,
                           math.radians(hfov_deg))
            f.step = get_step(Projection.RECTILINEAR, w, h,
                              math.radians(hfov_deg))
            f.yaw = math.radians(yaw_step * i - yaw_step * (n - 1) / 2)
            if lens:
                f.a, f.b, f.c = 0.01, -0.02, 0.005
            f.process_geometry()
            fcts.append(f)
            srcs.append(E.make_mount_source(
                f, rng.random((h, w, 3), dtype=np.float32), 3, 3))
        return fcts, srcs

    def mk_args(fct_or_fcts, projection, w, h, hfov_deg, degree,
                yaw=0.0, pitch=0.0, twine=0, synopsis="panorama"):
        fcts = fct_or_fcts if isinstance(fct_or_fcts, list) \
            else [fct_or_fcts]
        args = Args()
        args.projection = projection
        args.width, args.height = w, h
        args.hfov = math.radians(hfov_deg)
        args.extent = get_extent(projection, w, h, args.hfov)
        args.step = (args.extent.x1 - args.extent.x0) / w
        args.yaw, args.pitch = math.radians(yaw), math.radians(pitch)
        args.spline_degree = args.prefilter_degree = degree
        args.twine = twine
        args.synopsis = synopsis
        args.nchannels = 3
        args.facets = fcts
        args.solo = 0 if len(fcts) == 1 else -1
        if twine:
            args.twine_setup()
        return args

    def floor_of(args, sources, runs=1, strip=1024):
        plan = build_plan(args, args.facets)
        h, w = args.height, args.width
        windows = [(y, min(y + strip, h), 0, w)
                   for y in range(0, h, strip)]
        fns = [_compiled_window(plan, win) for win in windows]
        for fn in fns:
            jax.block_until_ready(fn(sources))
        t0 = time.perf_counter()
        for _ in range(runs):
            for fn in fns:
                jax.block_until_ready(fn(sources))
        dt = (time.perf_counter() - t0) / runs
        return w * h / 1e6 / dt

    def cfg_1():
        fct, src = sph_facet(4096, 2048, 1)
        a = mk_args(fct, Projection.RECTILINEAR, 1920, 1152, 90, 1,
                    yaw=30)
        return floor_of(a, [src], runs=3), "4K latlon -> HD rect bilinear"

    def cfg_2():
        fct, src = sph_facet(8192, 4096, 3)
        a = mk_args(fct, Projection.CUBEMAP, 2048, 6 * 2048, 90, 3)
        return floor_of(a, [src]), "8K equirect -> 6x2048 cubemap deg3"

    def cfg_2r():
        cfct, csrc = cube_src(2048, Projection.CUBEMAP, 90.0)
        a = mk_args(cfct, Projection.SPHERICAL, 8192, 4096, 360, 3)
        return floor_of(a, [csrc]), "cubemap -> 8K equirect deg3"

    def cfg_3():
        cfct, csrc = cube_src(1024)
        a = mk_args(cfct, Projection.STEREOGRAPHIC, 1920, 1152, 150, 3,
                    yaw=35, pitch=20)
        return floor_of(a, [csrc], runs=3), "biatan6 -> stereographic deg3"

    def cfg_3b():
        cfct, csrc = cube_src(1024)
        a = mk_args(cfct, Projection.FISHEYE, 1920, 1152, 170, 3,
                    yaw=-25, pitch=15)
        return floor_of(a, [csrc], runs=3), "biatan6 -> fisheye deg3"

    def cfg_4():
        fct, src = sph_facet(8192, 4096, 1)
        a = mk_args(fct, Projection.RECTILINEAR, 2048, 1280, 100, 1,
                    twine=-1)
        return floor_of(a, [src]), \
            f"8K -> 2K rect, {len(a.twine_spread)}-tap twine"

    def cfg_4b():
        fct, src = sph_facet(16384, 8192, 1)
        a = mk_args(fct, Projection.RECTILINEAR, 2048, 1280, 100, 1,
                    twine=-1)
        return floor_of(a, [src]), \
            f"16K -> 2K rect, {len(a.twine_spread)}-tap twine"

    def cfg_5():
        fcts, srcs = rect_facets(3, 65, 2048, 1536, 40)
        a = mk_args(fcts, Projection.SPHERICAL, 4096, 2048, 360, 3)
        return floor_of(a, srcs), "3-facet voronoi stitch deg3"

    def cfg_5b():
        fcts, srcs = rect_facets(6, 72, 1536, 1152, 60, lens=True)
        a = mk_args(fcts, Projection.SPHERICAL, 4096, 2048, 360, 3)
        return floor_of(a, srcs), "6-facet voronoi + lens deg3"

    def cfg_5c():
        fcts, srcs = [], []
        import dataclasses as _dc
        for i, eev in enumerate((-2.0, 0.0, 2.0)):
            f = Facet(facet_no=i, nchannels=3)
            f.set_geometry(Projection.SPHERICAL, 4096, 2048,
                           2 * math.pi)
            f.step = get_step(Projection.SPHERICAL, 4096, 2048,
                              2 * math.pi)
            f.process_geometry()
            fcts.append(f)
            s = E.make_mount_source(
                f, rng.random((2048, 4096, 3), dtype=np.float32)
                * 2.0 ** eev, 3, 3)
            s.static = _dc.replace(s.static, brighten=2.0 ** -eev)
            srcs.append(s)
        a = mk_args(fcts, Projection.SPHERICAL, 4096, 2048, 360, 3,
                    synopsis="hdr_merge")
        return floor_of(a, srcs), "3-bracket HDR merge deg3"

    def cfg_5d():
        fcts, srcs = rect_facets(6, 72, 1536, 1152, 60)
        a = mk_args(fcts, Projection.SPHERICAL, 4096, 2048, 360, 3,
                    twine=1)
        return floor_of(a, srcs), "6-facet voronoi + 4-tap twine deg3"

    configs = [("1", cfg_1), ("2", cfg_2), ("2r", cfg_2r),
               ("3", cfg_3), ("3b", cfg_3b), ("4", cfg_4),
               ("4b", cfg_4b), ("5", cfg_5), ("5b", cfg_5b),
               ("5c", cfg_5c), ("5d", cfg_5d)]
    only = [a for a in sys.argv[1:] if not a.startswith("-")]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, "CPU_FLOORS.json")
    floors = {}
    if os.path.exists(path):
        with open(path) as f:
            floors = json.load(f)
    for tag, fn in configs:
        if only and tag not in only:
            continue
        mpix, desc = fn()
        rec = {"config": desc, "value": round(mpix, 2),
               "unit": "Mpix/s", "ncores": os.cpu_count(),
               "when": time.strftime("%Y-%m-%d")}
        floors[tag] = rec
        print(json.dumps({"tag": tag, **rec}))
    with open(path, "w") as f:
        json.dump(floors, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
