"""Headline benchmark: 8K equirect -> 6x2048 cubemap reprojection,
degree-3 b-spline + prefilter (BASELINE.json config 2), on one GPU.

Times the normal render path: the jitted frame (``_compiled_window``)
ending in ``block_until_ready``, and ``render_frame``, which adds the
copy of the frame to the host; medians of repeated warm runs. Host
file I/O is excluded, matching the reference's 'frame rendering time'
(envutil_payload.cc:476-557).

Prints ONE JSON line naming the device (platform, device_kind, count)
and the card's name and power limit. Exits non-zero without a GPU.

    python bench.py
"""

import json
import math
import statistics
import sys
import time

import numpy as np

RUNS = 20


def timed(fn, runs: int = RUNS):
    """Median and all times (ms) of ``runs`` warm calls of ``fn``."""
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times


def main(argv=None) -> int:
    from envutil.runtime import device

    device.setup_compile_cache()
    device.require_gpu()
    import jax

    from envutil.core.conventions import Projection
    from envutil.core.facet import Facet
    from envutil.core.metrics import get_extent, get_step
    from envutil.models import environment as E
    from envutil.runtime.args import Args
    from envutil.runtime.render import (_compiled_window, build_plan,
                                        render_frame)

    w, h = 8192, 4096
    yy, xx = np.meshgrid(np.linspace(0, 1, h, dtype=np.float32),
                         np.linspace(0, 1, w, dtype=np.float32),
                         indexing="ij")
    img = np.stack([xx, yy, (xx * yy)], axis=-1)
    fct = Facet(facet_no=0, nchannels=3)
    fct.set_geometry(Projection.SPHERICAL, w, h, 2 * math.pi)
    fct.step = get_step(Projection.SPHERICAL, w, h, 2 * math.pi)
    fct.process_geometry()
    src = E.make_mount_source(fct, img, 3, 3)

    args = Args()
    args.projection = Projection.CUBEMAP
    args.width, args.height = 2048, 6 * 2048
    args.hfov = math.pi / 2
    args.extent = get_extent(Projection.CUBEMAP, 2048, 6 * 2048, args.hfov)
    args.step = (args.extent.x1 - args.extent.x0) / args.width
    args.spline_degree = args.prefilter_degree = 3
    args.twine = 0
    args.synopsis = "panorama"
    args.nchannels = 3
    args.facets = [fct]
    args.solo = 0
    plan = build_plan(args, [fct])
    fn = _compiled_window(plan, (0, plan.height, 0, plan.width))

    frame_ms, _ = timed(lambda: jax.block_until_ready(fn([src])))
    e2e_ms, _ = timed(lambda: render_frame(plan, [src]))
    n_px = plan.width * plan.height
    print(json.dumps({
        "metric": "reprojection Mpix/s (8K equirect -> 6x2048 cubemap, "
                  "degree-3 b-spline, jitted frame)",
        "value": round(n_px / 1e3 / frame_ms, 2),
        "unit": "Mpix/s",
        "frame_ms": round(frame_ms, 4),
        "render_frame_ms": round(e2e_ms, 3),
        "runs": RUNS,
        "device": device.device_record(),
        "card": device.card_info(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
