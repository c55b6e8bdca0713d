"""Render orchestration: builds one jitted XLA program per job shape.

This is the equivalent of the reference's dispatch/roll_out/fuse
stack (envutil_payload.cc:1885-2435): run-time parameters that the
reference turns into C++ template instantiations (channel count,
projection/stepper type, synopsis type, twining on/off) here select the
traced graph; the graph itself is

    per facet: target raster -> rays in facet CS   (models/stepper)
    synopsis over facets (+ twining taps)          (models/synopsis)
    -> (H, W, C) image

Facet coefficient arrays enter as jit *arguments* (pytrees), so a
compiled program is reused across frames/images of the same shape - the
basis of the streaming and serve modes.

Translation / lens-corrected paths (PTO TrX/TrY/TrZ, Tpy/Tpp, --single)
use the 'generic' transform chain (generic_r3 / tf_ex_facet,
envutil_payload.cc:1629-1883) instead of a plain rotation.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import geometry as geo
from ..core.conventions import Projection
from ..core.facet import Facet
from ..core.metrics import Extent
from ..core.rotation import rotation_rpy
from ..models import environment as E
from ..models import lens as L
from ..models import stepper as ST
from ..models import synopsis as SYN


# ---------------------------------------------------------------------------
# 3D->3D transform chains (generic_r3 / tf3d_t)
# ---------------------------------------------------------------------------

def _tf3d(r1: np.ndarray, r2: np.ndarray, shift: np.ndarray,
          dcp: float = 1.0) -> Callable:
    """Rotate to an intermediate CS, optionally reproject onto the
    plane z=1, scale by dcp, shift, rotate on (tf3d_t,
    geometry.h:1851-1942). Rays behind the reprojection plane are
    poisoned with z = -inf."""
    has_shift = bool(np.any(shift != 0.0))
    if not has_shift:
        # collapse to a single rotation
        m = r2 if r1 is None else r2 @ r1

        def g(x, y, z):
            return geo.apply_matrix(m, x, y, z)
        return g

    def f(x, y, z):
        x, y, z = geo.apply_matrix(r1, x, y, z)
        bad = z <= 0.0
        zz = jnp.where(bad, 1.0, z)
        px = (x / zz) * dcp - shift[0]
        py = (y / zz) * dcp - shift[1]
        pz = jnp.full_like(z, dcp - shift[2])
        px, py, pz = geo.apply_matrix(r2, px, py, pz)
        inf = jnp.asarray(np.float32("inf"), z.dtype)
        px = jnp.where(bad, 0.0, px)
        py = jnp.where(bad, 0.0, py)
        pz = jnp.where(bad, -inf, pz)
        return px, py, pz
    return f


def generic_r3(ft: Facet, fs: Facet) -> Callable:
    """Full target->source ray transform honoring translation planes on
    both sides (generic_r3, envutil_payload.cc:1629-1822). ``ft`` is
    the target geometry (usually args; a facet for --single), ``fs``
    the source facet."""
    r_cam = rotation_rpy(ft.roll, ft.pitch, ft.yaw)
    r_ttp = rotation_rpy(ft.tp_r, ft.tp_p, ft.tp_y)
    r_stp = rotation_rpy(fs.tp_r, fs.tp_p, fs.tp_y)
    r_f = rotation_rpy(fs.roll, fs.pitch, fs.yaw)

    have_ttp = ft.tr_x != 0 or ft.tr_y != 0 or ft.tr_z != 0
    have_stp = fs.tr_x != 0 or fs.tr_y != 0 or fs.tr_z != 0

    shift_t = np.array([ft.tr_x, ft.tr_y, ft.tr_z], np.float64)
    if ft.tp_y != 0 or ft.tp_p != 0 or ft.tp_r != 0:
        shift_t = r_ttp.T @ shift_t
    dcp = 1.0 - shift_t[2]
    shift_t = -shift_t

    shift_s = np.array([fs.tr_x, fs.tr_y, fs.tr_z], np.float64)
    if fs.tp_y != 0 or fs.tp_p != 0 or fs.tp_r != 0:
        shift_s = r_stp.T @ shift_s

    if have_ttp and have_stp:
        f1 = _tf3d(r_ttp.T @ r_cam, r_ttp, shift_t, dcp)
        f2 = _tf3d(r_stp.T, r_f.T @ r_stp, shift_s)
        return lambda x, y, z: f2(*f1(x, y, z))
    if have_ttp:
        return _tf3d(r_ttp.T @ r_cam, r_f.T @ r_ttp, shift_t, dcp)
    if have_stp:
        return _tf3d(r_stp.T @ r_cam, r_f.T @ r_stp, shift_s)
    return _tf3d(None, r_f.T @ r_cam, np.zeros(3))


def tf_ex_facet(ft: Facet, fs: Facet) -> Callable:
    """planar (target model space) -> ray in the source facet's CS,
    including the inverse planar transform when the *target* is a
    lens-corrected facet (--single re-creation; tf_ex_facet,
    envutil_payload.cc:1841-1883). Returns fn(px, py) -> ray."""
    tf33 = generic_r3(ft, fs)
    tf23 = geo.to_ray(ft.projection,
                      section_md=(ft.extent.x1 - ft.extent.x0),
                      refc_md=(ft.extent.x1 - ft.extent.x0) / 2.0)
    tf22 = L.pto_planar_inverse(ft) if ft.has_2d_tf else None

    def f(px, py):
        if tf22 is not None:
            px, py = tf22(px, py)
        ray = tf23(px, py)
        return tf33(*ray)
    return f


# ---------------------------------------------------------------------------
# render graph
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)  # identity hash: one plan per job
class RenderPlan:
    """Everything static needed to trace one frame. Built host-side
    from Args + facet specs; the basis matrices / transform chains are
    baked into the jaxpr as constants."""
    projection: Projection
    width: int
    height: int
    extent: Extent
    nchannels: int
    synopsis: str
    spread: Optional[tuple]       # None = no twining
    # tangent-plane projection of the twining derivative rays
    # (--twine_precise; twining.h:74,152-263): instead of plain
    # differencing, the neighbour rays are orthogonally projected
    # onto the pickup ray's tangent plane before the spread deflects
    # along them
    twine_precise: bool = False
    solo: int = -1
    # one entry per participating facet:
    facet_indices: Tuple[int, ...] = ()
    bases: Tuple = ()             # 3x3 np arrays or None
    planar_to_ray: Tuple = ()     # callables or None (generic path)
    # output cropping (p-line S clause)
    crop: Optional[Tuple[int, int, int, int]] = None  # y0,y1,x0,x1


def build_plan(args, facets: Sequence[Facet]) -> RenderPlan:
    """The fuse() decision tree (envutil_payload.cc:2028-2283): per
    facet, either a pre-rotated 'fast lane' basis matrix or a generic
    planar->ray chain when translation / --single lens effects are in
    play."""
    cam = (args.roll, args.pitch, args.yaw)

    generic_target = False
    if args.single >= 0:
        fct = facets[args.single]
        if fct.has_2d_tf or fct.has_translation:
            generic_target = True

    if args.solo >= 0:
        indices = [args.solo]
    else:
        indices = list(range(len(facets)))

    bases, p2r = [], []
    for i in indices:
        fct = facets[i]
        if generic_target or fct.has_translation:
            bases.append(None)
            p2r.append(tf_ex_facet(args.as_facet(), fct))
        else:
            r_cam = rotation_rpy(*cam)
            r_f = rotation_rpy(fct.roll, fct.pitch, fct.yaw)
            bases.append(r_f.T @ r_cam)
            p2r.append(None)

    crop = None
    if getattr(args, "store_cropped", False):
        crop = (args.p_crop_y0, args.p_crop_y1,
                args.p_crop_x0, args.p_crop_x1)

    # twine == -1 with an empty spread means twine_setup was skipped
    # (API misuse): render untwined rather than summing zero taps
    spread = tuple(tuple(t) for t in args.twine_spread) \
        if (args.twine != 0 and args.twine_spread) else None

    return RenderPlan(
        projection=args.projection, width=args.width, height=args.height,
        extent=args.extent, nchannels=int(args.nchannels),
        synopsis=args.synopsis, spread=spread,
        twine_precise=bool(getattr(args, "twine_precise", False)
                           and spread is not None),
        solo=args.solo,
        facet_indices=tuple(indices), bases=tuple(bases),
        planar_to_ray=tuple(p2r), crop=crop)


def _render_window(plan: RenderPlan, sources: List[E.FacetSource],
                   window) -> jnp.ndarray:
    """Trace one output window: rays per facet + synopsis (+twining)."""
    nch = plan.nchannels
    if plan.spread is None:
        rays = [ST.target_rays(plan.projection, plan.width, plan.height,
                               plan.extent, basis=b, normalize=True,
                               planar_to_ray=p, window=window)
                for b, p in zip(plan.bases, plan.planar_to_ray)]
        if len(sources) == 1:
            px, mask = E.lookup(sources[0], rays[0], nch)
            return jnp.where(mask[..., None], px, 0.0)
        syn = SYN.pick_synopsis(plan.synopsis, nch)
        return syn(sources, rays, nch)

    packs = [ST.target_ninepack(plan.projection, plan.width, plan.height,
                                plan.extent, basis=b, normalize=True,
                                planar_to_ray=p, window=window)
             for b, p in zip(plan.bases, plan.planar_to_ray)]
    if len(sources) == 1:
        def solo_syn(srcs, rays_, n):
            px, mask = E.lookup(srcs[0], rays_[0], n)
            return jnp.where(mask[..., None], px, 0.0)
        return SYN.twined(solo_syn, sources, packs, nch, plan.spread,
                          precise=plan.twine_precise)
    syn = SYN.pick_synopsis(plan.synopsis, nch)
    return SYN.twined(syn, sources, packs, nch, plan.spread,
                      precise=plan.twine_precise)


@functools.lru_cache(maxsize=64)
def _compiled_window(plan: RenderPlan, window) -> Callable:
    return jax.jit(lambda sources: _render_window(plan, sources, window))


def _row_chunks(plan: RenderPlan, n_sources: int, n_px: int) -> int:
    """Number of row strips that keeps the traced working set (pixels x
    facets x channels x taps of float32 intermediates) within an eighth
    of what the device lets this process allocate. One strip where the
    backend reports no limit (the CPU)."""
    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        return 1
    taps = len(plan.spread) if plan.spread else 1
    per_px = 4 * max(1, n_sources) * (4 + plan.nchannels) * max(1, taps // 4)
    return max(1, -(-n_px * per_px // (limit // 8)))


def render_frame(plan: RenderPlan, sources: List[E.FacetSource],
                 verbose: bool = False,
                 amplify: Optional[float] = None,
                 mesh_n: int = 0,
                 shard_table: bool = False) -> np.ndarray:
    """Run a frame: possibly in row strips (memory bound), returns the
    host-side (H, W, C) float32 array. Timing is reported like the
    reference's 'frame rendering time' (envutil_payload.cc:546-557).

    Every job runs the XLA graph of ``_render_window``. ``mesh_n > 1``
    (the --mesh option) shards the output rows over that many devices
    (sources replicated, zero-communication SPMD - the reference's
    thread-pool tile decomposition ridden on the device mesh); it
    raises when fewer devices exist and renders on one device when the
    output height does not divide. ``shard_table`` (the --shard_table
    option, with --mesh) row-band-shards the facet coefficient tables
    themselves over the mesh and evaluates through the ppermute ring
    (parallel/mesh.ring_sharded_render)."""
    if mesh_n and mesh_n > 1:
        img = _render_frame_mesh(plan, sources, mesh_n, verbose,
                                 amplify, shard_table)
        if img is not None:
            return img

    if plan.crop is not None:
        y0, y1, x0, x1 = plan.crop
    else:
        y0, y1, x0, x1 = 0, plan.height, 0, plan.width
    n_px = (y1 - y0) * (x1 - x0)
    rows = y1 - y0
    chunks = _row_chunks(plan, len(sources), n_px)
    chunk_rows = max(1, (rows + chunks - 1) // chunks)

    start = time.perf_counter()
    parts = []
    yy = y0
    while yy < y1:
        ye = min(yy + chunk_rows, y1)
        window = (yy, ye, x0, x1)
        fn = _compiled_window(plan, window)
        out = fn(sources)
        if amplify is not None:
            out = E.apply_brighten(out, amplify)
        parts.append(out)
        yy = ye
    img = jnp.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
    img = np.asarray(jax.device_get(img), np.float32)
    msec = (time.perf_counter() - start) * 1000.0
    if verbose:
        print(f"frame rendering time: {msec:.1f} ms "
              f"({n_px / 1e6 / (msec / 1000.0):.1f} Mpix/s)")
    render_frame.last_ms = msec
    return img


render_frame.last_ms = 0.0


def _render_frame_mesh(plan: RenderPlan, sources, mesh_n: int,
                       verbose: bool, amplify,
                       shard_table: bool = False
                       ) -> Optional[np.ndarray]:
    """--mesh N: output rows sharded over an N-device mesh, sources
    replicated (or, with --shard_table, row-band-sharded and ring-
    evaluated). Raises when fewer than N devices exist; returns None
    (with a message) when the output height does not divide over N -
    the caller then renders on one device."""
    from ..parallel import mesh as PM

    devices = jax.devices()
    if len(devices) < mesh_n:
        raise ValueError(f"--mesh {mesh_n}: only {len(devices)} "
                         "device(s) available")
    y0, y1 = (plan.crop[0], plan.crop[1]) if plan.crop is not None \
        else (0, plan.height)
    if (y1 - y0) % mesh_n != 0:
        print(f"--mesh {mesh_n}: output height {y1 - y0} not "
              f"divisible by {mesh_n}; rendering on one", flush=True)
        return None

    start = time.perf_counter()
    mesh = PM.make_mesh(devices[:mesh_n])
    ring = shard_table and PM.shard_table_eligible(plan, sources)
    if shard_table and not ring:
        print("--shard_table: job not eligible (twining or "
              "masking); rendering with replicated tables", flush=True)
    if ring:
        srcs = PM.shard_sources(sources, mesh)
        fn = PM.ring_sharded_render(plan, srcs, mesh)
    else:
        srcs = PM.replicate_sources(sources, mesh)
        fn = PM.sharded_render(plan, srcs, mesh)
    out = fn(srcs)
    if amplify is not None:
        out = E.apply_brighten(out, amplify)
    img = np.asarray(jax.device_get(out), np.float32)
    msec = (time.perf_counter() - start) * 1000.0
    if verbose:
        n_px = img.shape[0] * img.shape[1]
        print(f"frame rendering time: {msec:.1f} ms "
              f"({n_px / 1e6 / (msec / 1000.0):.1f} Mpix/s, {mesh_n} devices"
              f"{', ring-sharded tables' if ring else ''})")
    render_frame.last_ms = msec
    return img
