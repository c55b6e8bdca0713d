"""Multi-device rendering: shard the output raster over a device mesh.

The reference's only scale-out axes are SIMD lanes and a thread pool
over output segments (SURVEY.md 2.7); the honest device analogue is
SPMD over the output raster: each device renders a horizontal band of the
target, facet coefficient arrays replicated (they are read-only
gather tables). XLA partitions the elementwise ray math spatially and
keeps gathers local because the operands are replicated - no
collectives on the forward path, which is exactly the reference's
zero-communication tile decomposition (wielding.h:240-265), ridden on
the device mesh instead of a thread pool.

For sources too large to replicate (16K+), ``ring_spline_eval`` shards
the coefficient table itself in row bands over the same axis and
ring-rotates the bands through every device with ``ppermute``,
accumulating each band's partial tensor-product sums - the reference's
out-of-core tile store (zimt/tiles.h) promoted to the device mesh
(SURVEY.md section 5 'long-sequence analog'): peak per-device residency
is two bands instead of the whole table.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np
try:
    from jax import shard_map  # jax >= 0.8
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import geometry as geo
from ..core.conventions import Projection
from ..models import environment as E
from ..ops import spline as S
from ..runtime.render import RenderPlan, _render_window


def make_mesh(devices: Optional[list] = None, axis: str = "rows") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def sharded_render(plan: RenderPlan, sources: List[E.FacetSource],
                   mesh: Mesh, axis: str = "rows"):
    """Jit the full-frame render with the output sharded over ``axis``
    (rows of the target raster) and sources replicated. Returns the
    compiled callable; call it with the sources list."""
    n = mesh.shape[axis]
    height = plan.height if plan.crop is None else \
        (plan.crop[1] - plan.crop[0])
    assert height % n == 0, \
        f"output height {height} must divide the mesh axis {n}"

    window = None if plan.crop is None else \
        (plan.crop[0], plan.crop[1], plan.crop[2], plan.crop[3])

    out_sharding = NamedSharding(mesh, P(axis, None, None))
    repl = NamedSharding(mesh, P())

    def fn(srcs):
        return _render_window(plan, srcs, window)

    flat, _ = jax.tree_util.tree_flatten(sources)
    in_shardings = jax.tree_util.tree_map(lambda _: repl, sources)
    return jax.jit(fn, in_shardings=(in_shardings,),
                   out_shardings=out_sharding)


def replicate_sources(sources: List[E.FacetSource], mesh: Mesh
                      ) -> List[E.FacetSource]:
    repl = NamedSharding(mesh, P())
    return jax.device_put(sources, jax.tree_util.tree_map(
        lambda _: repl, sources))


# ---------------------------------------------------------------------------
# facet-sharded evaluation: ring-rotated coefficient bands
# ---------------------------------------------------------------------------

def shard_spline_rows(spl: S.Spline2D, mesh: Mesh, axis: str = "rows"
                      ) -> S.Spline2D:
    """Shard a spline's padded coefficient table in row bands over the
    mesh axis (padding the row count to a multiple of the axis size;
    the pad rows are never addressed - row indices are clamped to the
    real table). The returned spline is only evaluable through
    ring_spline_eval."""
    n = mesh.shape[axis]
    hp, wp, ch = spl.coeff.shape
    b = -(-hp // n)
    coeff = spl.coeff
    if b * n != hp:
        coeff = jnp.pad(coeff, ((0, b * n - hp), (0, 0), (0, 0)))
    coeff = jax.device_put(coeff, NamedSharding(mesh, P(axis, None,
                                                        None)))
    return S.Spline2D(coeff=coeff, pad=spl.pad, degree=spl.degree,
                      bcs=spl.bcs, core_shape=spl.core_shape)


def ring_spline_eval(spl: S.Spline2D, x, y, mesh: Mesh,
                     axis: str = "rows", apply_gate: bool = True):
    """Exact gated b-spline evaluation with the coefficient table
    sharded in row bands over ``axis`` (shard_spline_rows) and the
    output raster rows sharded over the same axis.

    N ring steps: at step s each device holds band ``(d + s) % N``,
    accumulates the partial tensor-product sum of the vertical taps
    whose source rows live in that band, and passes the band to its
    ring neighbor (``lax.ppermute`` - one hop). Taps whose
    support straddles a band boundary are completed when the
    neighboring band arrives, so no halo copies are needed. Per-device
    residency: two bands (compute + in-flight) instead of the
    whole table - the scaling path for 16K+ sources; compute cost is
    N partial passes, so use the smallest mesh that fits the table.

    Exactness: each vertical tap j is accumulated into its own carry
    slot (a tap's row lives in exactly one band; the other ring steps
    add exact zeros) and the slots are reduced in ascending-j order
    after the loop - the same taps, weights, and left-associated
    summation order as eval_spline. The only residual versus the
    replicated evaluation is instruction-level: XLA may contract a
    final mul-add pair into an FMA in one program shape and not the
    other, which changes results by <= 2 ulp (observed 2.4e-7 on [0,1]
    data). There is no algorithmic approximation."""
    n = spl.degree
    h, w = spl.core_shape
    if apply_gate:
        x = S.gate(x, spl.bcs[1], w)
        y = S.gate(y, spl.bcs[0], h)
    nd = mesh.shape[axis]
    hp, wp, ch = spl.coeff.shape  # hp already padded to nd * band
    band_h = hp // nd
    real_h = spl.core_shape[0] + 2 * spl.pad

    def run(band, xl, yl):
        d = jax.lax.axis_index(axis)
        sx, tx = S.split(xl, n)
        sy, ty = S.split(yl, n)
        wx = S._weights(tx, n)
        wy = S._weights(ty, n)
        # integer pad shift after the split (exact, matching
        # eval_spline's bx = sx + (pad - n // 2))
        off = spl.pad - n // 2
        by = jnp.clip(sy + off, 0, real_h - 1 - n)
        bx = jnp.clip(sx + off, 0, wp - 1 - n)

        def body(s, carry):
            accs, bnd = carry
            owner = jax.lax.rem(d + s.astype(jnp.int32),
                                jnp.int32(nd))
            row0 = owner * band_h
            flat = bnd.reshape(band_h * wp, ch)
            accs = list(accs)
            for j in range(n + 1):
                row = jnp.minimum(by + j, real_h - 1)
                m = (row >= row0) & (row < row0 + band_h)
                lr = jnp.clip(row - row0, 0, band_h - 1)
                racc = None
                for k in range(n + 1):
                    cx = jnp.minimum(bx + k, wp - 1)
                    idx = (lr * wp + cx).reshape(-1)
                    tap = jnp.take(flat, idx, axis=0, mode="clip")
                    tap = tap.reshape(lr.shape + (ch,))
                    term = wx[k][..., None] * tap
                    racc = term if racc is None else racc + term
                wj = jnp.where(m, wy[j], 0.0)
                accs[j] = accs[j] + wj[..., None] * racc
            bnd = jax.lax.ppermute(
                bnd, axis, [(i, (i - 1) % nd) for i in range(nd)])
            return tuple(accs), bnd

        # match eval_spline's promotion (x64 test configs feed f64
        # coordinates; production coordinates are f32)
        acc0 = jnp.zeros(xl.shape + (ch,),
                         jnp.promote_types(xl.dtype, band.dtype))
        # the loop carry becomes device-varying after the first
        # ppermute; mark the initial carry accordingly
        if hasattr(jax.lax, "pcast"):
            acc0 = jax.lax.pcast(acc0, (axis,), to="varying")
        elif hasattr(jax.lax, "pvary"):
            acc0 = jax.lax.pvary(acc0, (axis,))
        accs, _ = jax.lax.fori_loop(
            0, nd, body, (tuple(acc0 for _ in range(n + 1)), band))
        out = accs[0]
        for j in range(1, n + 1):
            out = out + accs[j]
        return out

    fn = shard_map(run, mesh=mesh,
                   in_specs=(P(axis, None, None), P(axis, None),
                             P(axis, None)),
                   out_specs=P(axis, None, None))
    return fn(spl.coeff, x, y)


# ---------------------------------------------------------------------------
# --shard_table: full renders from ring-sharded coefficient tables
# ---------------------------------------------------------------------------

def shard_sources(sources: List[E.FacetSource], mesh: Mesh,
                  axis: str = "rows") -> List[E.FacetSource]:
    """Row-band-shard every facet's coefficient table over the mesh.
    Paint sources pass through unchanged."""
    out = []
    for src in sources:
        if src.spl is None:
            out.append(src)
            continue
        out.append(E.FacetSource(
            static=src.static,
            spl=shard_spline_rows(src.spl, mesh, axis)))
    return out


def shard_table_eligible(plan: RenderPlan,
                         sources: List[E.FacetSource]) -> bool:
    """--shard_table serves untwined plain-lookup jobs (tables beyond
    one device's memory come from huge environment sources;
    masking/paint jobs keep the replicated path)."""
    if plan.spread is not None:
        return False
    return all(src.spl is not None and src.static.masked == -1
               for src in sources)


def ring_sharded_render(plan: RenderPlan,
                        sources: List[E.FacetSource], mesh: Mesh,
                        axis: str = "rows"):
    """Jit the full-frame render with every facet's coefficient table
    row-band-sharded over ``axis`` (shard_sources) and the output rows
    sharded over the same axis - the end-to-end form of
    ring_spline_eval (the reference's out-of-core tile store wired
    into zimt::process as get_t/put_t, zimt/tiles.h:354-1337).

    The traced graph mirrors runtime/render._render_window exactly
    (same ray math, same lookup tail, same synopsis combines), with
    eval_spline replaced by the ring evaluation - which reduces its
    vertical taps in the same order - so the output matches the
    replicated render to <= 2 ulp (FMA contraction differences between
    the two program shapes; see ring_spline_eval). Returns the
    compiled callable; call it with the sharded sources list."""
    from ..models import stepper as ST
    from ..models import synopsis as SYN

    n = mesh.shape[axis]
    height = plan.height if plan.crop is None else \
        (plan.crop[1] - plan.crop[0])
    assert height % n == 0, \
        f"output height {height} must divide the mesh axis {n}"
    assert shard_table_eligible(plan, sources), \
        "--shard_table supports untwined plain-lookup jobs"
    window = None if plan.crop is None else tuple(plan.crop)
    nch = plan.nchannels

    def lookup_ring(src, ray):
        """E.lookup with the spline evaluated through the ring
        (environment.lookup tail reproduced verbatim)."""
        st = src.static
        if st.kind == "cubemap":
            face, fx, fy = geo.ray_to_cubeface(*ray)
            if st.projection == Projection.BIATAN6:
                fx = (4.0 / math.pi) * jnp.arctan(fx)
                fy = (4.0 / math.pi) * jnp.arctan(fy)
            cx, cy = st.metrics.get_pickup_coordinate_px(face, fx, fy)
            px = ring_spline_eval(src.spl, cx, cy, mesh, axis,
                                  apply_gate=False)
            mask = jnp.ones(ray[0].shape, dtype=bool)
        else:
            sx, sy, mask = E.source_spline_coords(src, ray)
            px = ring_spline_eval(src.spl, sx, sy, mesh, axis)
            px = jnp.where(mask[..., None], px, 0.0)
        px = E.repix(px, nch)
        if st.brighten != 1.0:
            px = E.apply_brighten(px, st.brighten)
        return px, mask

    def fn(srcs):
        rays = [ST.target_rays(plan.projection, plan.width,
                               plan.height, plan.extent, basis=b,
                               normalize=True, planar_to_ray=p,
                               window=window)
                for b, p in zip(plan.bases, plan.planar_to_ray)]
        if len(srcs) == 1:
            px, mask = lookup_ring(srcs[0], rays[0])
            return jnp.where(mask[..., None], px, 0.0)
        if plan.synopsis == "hdr_merge":
            px_list = [lookup_ring(s, r)[0]
                       for s, r in zip(srcs, rays)]
            return SYN.hdr_merge_stack(
                px_list, [s.static.brighten for s in srcs], nch)
        pxs, masks, scores = [], [], []
        for src, ray in zip(srcs, rays):
            px, mask = lookup_ring(src, ray)
            z = ray[2] * src.static.recip_step
            pxs.append(px)
            masks.append(mask)
            scores.append(jnp.where(mask, z, SYN._LOWEST))
        px, mask, score = (jnp.stack(pxs), jnp.stack(masks),
                           jnp.stack(scores))
        if nch in (1, 3):
            return SYN.voronoi_stack(px, mask, score)
        return SYN.voronoi_plus_stack(px, mask, score)

    out_sharding = NamedSharding(mesh, P(axis, None, None))
    return jax.jit(fn, out_shardings=out_sharding)
