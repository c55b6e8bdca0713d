"""Command-line driver.

Job modes match the reference (envutil_main.cc:1634-1983):
  * single job: `envutil --input in.exr --output out.exr ...`
  * --split: loop of --single jobs re-creating each facet
  * streaming mode: trailing '-' reads argument lines from stdin and
    re-runs the core with assets persisting across jobs
  * tethered serve mode: trailing '+' (socket transport,
    runtime/serve.py) or '++' (shared-memory frame buffers with the
    visor pipeline semantics, runtime/visor.py)
"""

from __future__ import annotations

import shlex
import sys
from typing import List

from ..core.conventions import PROJECTION_NAMES
from ..io import imgio
from . import assets, loader
from .args import D2R, parse_args
from .device import setup_compile_cache
from .render import build_plan, render_frame

# cumulated frame rendering time (rt_cumulated, envutil_main.cc:1620)
rt_cumulated = 0.0


def cp_statistics(args, sources) -> None:
    """Control-point intensity check: sample a 4x4 window around each
    control point in both facets, pool the intensity sums per facet
    pair, echo the matrix and the pairwise brightness ratios. This is
    a working version of the reference's experimental CP-statistics
    block (envutil_payload.cc:1950-2026, disabled there), generalized
    to any facet count; it's what -v exposes when a PTO has c-lines."""
    import jax.numpy as jnp
    import numpy as np

    from ..ops import spline as S

    nf = len(sources)
    s = np.zeros((nf, nf), np.float64)
    offs = np.arange(4, dtype=np.float32) - 1.5
    dx, dy = np.meshgrid(offs, offs)
    for cp in args.cp_list:
        if cp.t != 0:      # only 'normal' points carry intensity info
            continue
        for fi, x, y, fj in ((cp.n, cp.x, cp.y, cp.N),
                             (cp.N, cp.X, cp.Y, cp.n)):
            if not (0 <= fi < nf) or sources[fi].spl is None:
                continue
            px = S.eval_spline(sources[fi].spl,
                               jnp.asarray(x + dx), jnp.asarray(y + dy))
            nch = px.shape[-1]
            colour = px[..., :nch - 1] if nch in (2, 4) else px
            s[fi][fj] += float(jnp.sum(colour))
    print("CP intensity check:")
    for j in range(nf):
        print(" ".join(f"{s[i][j]:.6g}" for i in range(nf)))
    for i in range(nf):
        for j in range(i):
            if s[j][i] != 0.0:
                print(f"{i}:{j} {s[i][j] / s[j][i]:.6g}")


def _run_job(args) -> None:
    """One rendition: load facets, build plan, render, save."""
    global rt_cumulated
    sources = [loader.load_source(f, args) for f in args.facets]
    if args.verbose and args.cp_list:
        cp_statistics(args, sources)
    plan = build_plan(args, args.facets)
    active = [sources[i] for i in plan.facet_indices]

    # for 'single' jobs, undo the target facet's own brighten
    # (envutil_payload.cc:481-512)
    amplify = None
    if args.single >= 0:
        b = args.facets[args.single].brighten
        if b != 1.0:
            amplify = 1.0 / b

    img = render_frame(plan, active, verbose=args.verbose,
                       amplify=amplify, mesh_n=args.mesh,
                       shard_table=args.shard_table)
    rt_cumulated += render_frame.last_ms

    if args.mask_for != -1 and img.shape[-1] == 2:
        # after the synopsis the mask is (value*alpha, alpha); keep the
        # first channel as a plain grey mask (environment.h:1311-1323)
        img = img[..., :1]

    imgio.save_image(
        args.output, img,
        projection_name=PROJECTION_NAMES[args.projection],
        hfov_deg=args.hfov / D2R,
        working_colour_space=args.working_colour_space,
        output_colour_space=args.colour_space,
        verbose=args.verbose)


def core(argv: List[str], tethered: bool = False) -> int:
    args = parse_args(argv)
    args.tethered = tethered
    args.twine_setup()

    if args.split:
        # re-create each facet from the synopsis (--split,
        # envutil_main.cc:1679-1722); the solo facet is skipped
        for i in range(args.nfacets):
            if i == args.solo:
                continue
            sub = list(argv)
            # re-run with --single i and the split output name
            sub = [a for a in sub]
            out_name = args.split % i if "%" in args.split else args.split
            sub += ["--single", str(i), "--output", out_name]
            # remove the --split argument to avoid recursion
            clean = []
            skip = False
            for a in sub:
                if skip:
                    skip = False
                    continue
                if a == "--split":
                    skip = True
                    continue
                if a.startswith("--split="):
                    continue
                clean.append(a)
            sub_args = parse_args(clean)
            sub_args.store_cropped = False
            sub_args.twine_setup()
            _run_job(sub_args)
    else:
        if args.single != -1:
            args.store_cropped = False
        _run_job(args)

    assets.conclude_cycle()
    return 0


def main(argv: List[str] | None = None) -> int:
    setup_compile_cache()
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[-1] == "++":
        from .visor import render_loop as visor_loop
        visor_loop(verbose="-v" in argv or "--verbose" in argv)
        return 0
    if argv and argv[-1] == "+":
        from .serve import render_loop
        render_loop()
        return 0
    if not argv or argv[-1] != "-":
        return core(argv)
    # streaming mode: read argument lines from stdin, prepend the CL
    # arguments before '-' (envutil_main.cc:1948-1982)
    base = argv[:-1]
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        tokens = shlex.split(line)
        print(" " + " ".join(f"<{t}>" for t in tokens))
        core(base + tokens)
    print("pipe has reached EOF")
    return 0


if __name__ == "__main__":
    sys.exit(main())
