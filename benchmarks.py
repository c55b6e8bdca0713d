"""Multi-config benchmark sweep over the BASELINE.json configs, on one
GPU.

Prints one JSON line per config (bench.py is the single-line headline).
Each number is the median of repeated warm runs of the jitted frame of
the normal render path (``render._compiled_window``) ending in
``block_until_ready``; host file I/O is excluded, matching the
reference's 'frame rendering time' (envutil_payload.cc:476-557). Every
line names the device (platform, device_kind, count) and the card's
name and power limit. Exits non-zero without a GPU.

Configs (BASELINE.md / BASELINE.json):
  1.  4K 2:1 lat/lon -> 1920x1152 rectilinear, hfov 90, bilinear
  2r. 6x2048 cubemap -> 8K equirect, degree 3 (the headline reversed;
      the headline itself is bench.py)
  3.  biatan6 cubemap -> stereographic and fisheye, fov>90 faces,
      yaw/pitch sweeps
  4.  twining anti-aliased downscale: 8K equirect -> 2K rectilinear
      (auto twine), the true 16K source with bfloat16 coefficient
      storage, and the 16K source with --twine_pyramid
  5.  PTO-style stitches: 3-facet voronoi, 6-facet voronoi with PT lens
      correction, the 6-facet stitch with 4-tap twining, and a
      3-bracket Eev HDR merge

    python benchmarks.py [config tags, e.g. 1 4b 5]
"""

import dataclasses
import json
import math
import sys

import numpy as np

from bench import timed


def main(argv=None) -> int:
    from envutil.runtime import device

    device.setup_compile_cache()
    device.require_gpu()
    import jax

    from envutil.core.conventions import Projection
    from envutil.core.facet import Facet
    from envutil.core.metrics import get_extent, get_step
    from envutil.models import cubemap as CBM
    from envutil.models import environment as E
    from envutil.runtime.args import Args
    from envutil.runtime.loader import _apply_coeff_dtype
    from envutil.runtime.render import _compiled_window, build_plan

    card = device.card_info()
    record = device.device_record()

    def report(tag, name, plan, sources, note=""):
        fn = _compiled_window(plan, (0, plan.height, 0, plan.width))
        ms, _ = timed(lambda: jax.block_until_ready(fn(sources)), 10)
        n_px = plan.width * plan.height
        print(json.dumps({"config": tag, "name": name,
                          "value": round(n_px / 1e3 / ms, 1),
                          "unit": "Mpix/s", "frame_ms": round(ms, 4),
                          "note": note, "device": record, "card": card}),
              flush=True)

    def facet(projection, w, h, hfov_deg, no=0, yaw=0.0, **kw):
        f = Facet(facet_no=no, nchannels=3)
        f.set_geometry(projection, w, h, math.radians(hfov_deg))
        f.step = get_step(projection, w, h, math.radians(hfov_deg))
        f.yaw = math.radians(yaw)
        for k, v in kw.items():
            setattr(f, k, v)
        f.process_geometry()
        return f

    def env_source(w, h, degree, coeff="f32"):
        yy, xx = np.meshgrid(np.linspace(0, 1, h, dtype=np.float32),
                             np.linspace(0, 1, w, dtype=np.float32),
                             indexing="ij")
        fct = facet(Projection.SPHERICAL, w, h, 360.0)
        src = E.make_mount_source(fct, np.stack([xx, yy, xx * yy], -1),
                                  degree, degree)

        class _A:
            coeff_dtype = coeff
        _apply_coeff_dtype(src, _A())
        return fct, src

    def make_plan(facets, projection, w, h, hfov_deg, degree, yaw=0.0,
                  pitch=0.0, twine=0, synopsis="panorama", pyramid=False):
        args = Args()
        args.projection = projection
        args.width, args.height = w, h
        args.hfov = math.radians(hfov_deg)
        args.extent = get_extent(projection, w, h, args.hfov)
        args.step = (args.extent.x1 - args.extent.x0) / w
        args.yaw = math.radians(yaw)
        args.pitch = math.radians(pitch)
        args.spline_degree = args.prefilter_degree = degree
        args.twine = twine
        args.twine_pyramid = pyramid
        args.synopsis = synopsis
        args.nchannels = 3
        args.facets = facets
        args.solo = 0 if len(facets) == 1 else -1
        if twine:
            args.twine_setup()
        return args, build_plan(args, facets)

    def biatan6_source():
        faces = np.random.default_rng(3).random((6, 1024, 1024, 3),
                                                np.float32)
        cfct = facet(Projection.BIATAN6, 1024, 6144, 100.0)
        return cfct, CBM.make_cubemap_source(cfct, faces, 3, 3, 128, 64)

    def rect_facets(n, w, h, hfov_deg, yaws, lens=None, seed=5):
        rng = np.random.default_rng(seed)
        facets, srcs = [], []
        for i in range(n):
            f = facet(Projection.RECTILINEAR, w, h, hfov_deg, no=i,
                      yaw=yaws[i], **(lens or {}))
            facets.append(f)
            srcs.append(E.make_mount_source(
                f, rng.random((h, w, 3), np.float32), 3, 3))
        return facets, srcs

    def cfg_1():
        fct, src = env_source(4096, 2048, 1)
        _, plan = make_plan([fct], Projection.RECTILINEAR, 1920, 1152, 90,
                            1, yaw=30)
        report("1", "4K latlon -> 1920x1152 rectilinear bilinear", plan,
               [src])

    def cfg_2r():
        faces = np.random.default_rng(2).random((6, 2048, 2048, 3),
                                                np.float32)
        cfct = facet(Projection.CUBEMAP, 2048, 6 * 2048, 90.0)
        csrc = CBM.make_cubemap_source(cfct, faces, 3, 3, 128, 64)
        _, plan = make_plan([cfct], Projection.SPHERICAL, 8192, 4096, 360,
                            3)
        report("2r", "6x2048 cubemap -> 8K equirect deg-3", plan, [csrc])

    def cfg_3():
        cfct, csrc = biatan6_source()
        _, plan = make_plan([cfct], Projection.STEREOGRAPHIC, 1920, 1152,
                            150, 3, yaw=35, pitch=20)
        report("3", "biatan6(fov100) -> 1920x1152 stereographic deg-3 "
               "(yaw35/pitch20)", plan, [csrc])
        _, plan = make_plan([cfct], Projection.FISHEYE, 1920, 1152, 170,
                            3, yaw=-25, pitch=15)
        report("3b", "biatan6(fov100) -> 1920x1152 fisheye(170) deg-3 "
               "(yaw-25/pitch15)", plan, [csrc])

    def cfg_4():
        fct, src = env_source(8192, 4096, 1)
        args, plan = make_plan([fct], Projection.RECTILINEAR, 2048, 1280,
                               100, 1, twine=-1)
        report("4", "8K equirect -> 2048x1280 rectilinear, twining",
               plan, [src], f"{len(args.twine_spread)} taps")

    def cfg_4b():
        fct, src = env_source(16384, 8192, 1, coeff="bf16")
        args, plan = make_plan([fct], Projection.RECTILINEAR, 2048, 1280,
                               100, 1, twine=-1)
        report("4b", "16K equirect (bf16 coeff) -> 2048x1280 "
               "rectilinear, twining", plan, [src],
               f"{len(args.twine_spread)} taps")

    def cfg_4c():
        fbig = facet(Projection.SPHERICAL, 16384, 8192, 360.0)
        make_plan([fbig], Projection.RECTILINEAR, 2048, 1280, 100, 1,
                  twine=-1, pyramid=True)
        lvl = fbig.pyramid_level
        fct, src = env_source(16384 >> lvl, 8192 >> lvl, 1)
        args, plan = make_plan([fct], Projection.RECTILINEAR, 2048, 1280,
                               100, 1, twine=-1)
        report("4c", f"16K equirect -> 2048x1280 rectilinear, "
               f"--twine_pyramid (level {lvl})", plan, [src],
               f"{len(args.twine_spread)} taps")

    def cfg_5():
        facets, srcs = rect_facets(3, 2048, 1536, 65, (-40.0, 0.0, 40.0))
        _, plan = make_plan(facets, Projection.SPHERICAL, 4096, 2048, 360,
                            3)
        report("5", "3-facet voronoi stitch -> 4096x2048 equirect deg-3",
               plan, srcs)

    def cfg_5b():
        facets, srcs = rect_facets(
            6, 1536, 1152, 72, [60.0 * i for i in range(6)],
            lens=dict(a=0.01, b=-0.02, c=0.005))
        _, plan = make_plan(facets, Projection.SPHERICAL, 4096, 2048, 360,
                            3)
        report("5b", "6-facet voronoi + lens correction -> 4096x2048 "
               "deg-3", plan, srcs)

    def cfg_5d():
        facets, srcs = rect_facets(6, 1536, 1152, 72,
                                   [60.0 * i for i in range(6)])
        args, plan = make_plan(facets, Projection.SPHERICAL, 4096, 2048,
                               360, 3, twine=1)
        report("5d", "6-facet voronoi stitch + twining -> 4096x2048 "
               "deg-3", plan, srcs, f"{len(args.twine_spread)} taps")

    def cfg_5c():
        facets, srcs = [], []
        rng = np.random.default_rng(6)
        for i, eev in enumerate((-2.0, 0.0, 2.0)):
            f = facet(Projection.SPHERICAL, 4096, 2048, 360.0, no=i)
            facets.append(f)
            s = E.make_mount_source(
                f, rng.random((2048, 4096, 3), np.float32) * 2.0 ** eev,
                3, 3)
            s.static = dataclasses.replace(s.static, brighten=2.0 ** -eev)
            srcs.append(s)
        _, plan = make_plan(facets, Projection.SPHERICAL, 4096, 2048, 360,
                            3, synopsis="hdr_merge")
        report("5c", "3-bracket HDR merge -> 4096x2048 deg-3", plan, srcs)

    configs = [("4b", cfg_4b), ("4c", cfg_4c), ("1", cfg_1), ("3", cfg_3),
               ("4", cfg_4), ("5", cfg_5), ("2r", cfg_2r), ("5b", cfg_5b),
               ("5d", cfg_5d), ("5c", cfg_5c)]
    only = [a for a in (argv or []) if not a.startswith("-")]
    for tag, fn in configs:
        if not only or tag in only:
            fn()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
