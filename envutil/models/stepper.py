"""Target-side ray generation ('steppers').

The reference's steppers (stepper.h:215-1789) walk the target raster
and emit, per pixel, a 3D ray *already rotated into a source facet's
coordinate system*. Here the whole raster is materialized at once:
a stepper becomes

    planar grid (edge-to-edge affine, stepper.h:294-333)
    -> per-projection planar->ray (geometry.py)
    -> rotation by the camera-to-facet basis matrix
    -> optional normalization

with everything fused by XLA. The row-invariant sincos tricks of the
CPU steppers are unnecessary on the device; the basis-vector formulation
carries over 1:1 (ray = R_facet^T R_cam @ ray_target).

The 'deriv stepper' (stepper.h:1587-1715) becomes three planar grids
offset by a sub-pixel bias (0.25 of a step) whose rays are later
differenced for twining.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import jax.numpy as jnp
import numpy as np

from ..core import geometry as geo
from ..core.conventions import Projection

# sub-pixel offset used for derivative rays (stepper.h:1617: bias=.25);
# the twining code multiplies differences back up by 1/BIAS = 4.0
DERIV_BIAS = 0.25


def planar_axis(n: int, lo: float, hi: float, bias: float,
                dtype=np.float32, i0: int = 0,
                i1: int | None = None) -> np.ndarray:
    """Edge-to-edge sample positions: samples i0..i1 of an n-sample
    axis placed half a step inside [lo, hi] plus a bias offset in
    *sample-step* units (stepper.h:294-333: the doubled-int formulation
    keeps the samples exactly in range; we compute in float64
    host-side which is at least as precise). Indices beyond n
    extrapolate smoothly (used for tile padding)."""
    i1 = n if i1 is None else i1
    i = np.arange(i0, i1, dtype=np.float64)
    ll = 2.0 * i + 1.0
    fx0 = lo / (2.0 * n)
    fx1 = hi / (2.0 * n)
    b = bias * (hi - lo) / n
    return (b + ll * fx1 + (2.0 * n - ll) * fx0).astype(dtype)


def planar_axis_dyn(n: int, lo: float, hi: float, bias: float,
                    size: int, origin, dtype=jnp.float32):
    """Traced edge-to-edge sample positions for a window of ``size``
    samples starting at (traced) index ``origin`` of an n-sample axis -
    the dynamic-origin analogue of planar_axis, used for per-tile
    fallback rendering.

    Computed center-relative: value = (i + 0.5 + bias - n/2) * step +
    mid. With float32 tracing this keeps the error proportional to the
    distance from the raster center (~1 ulp of the value, matching the
    float64-then-cast host path) instead of the edge-anchored form's
    2x-plus-cancellation error - the paths agree to <1e-4 px even at
    32K rasters."""
    fdt = jnp.float64 if dtype == np.float64 else jnp.float32
    i = jnp.arange(size, dtype=fdt) + origin.astype(fdt)
    # host-side float64 constants, rounded once on entry to the trace
    step = (hi - lo) / n
    mid = (lo + hi) / 2.0
    ic = i + (0.5 + bias - 0.5 * n)
    return (ic * fdt(step) + fdt(mid)).astype(dtype)


def planar_grid_dyn(width: int, height: int, extent, size, origin,
                    bias=(0.0, 0.0), dtype=jnp.float32):
    """planar_grid with a traced window origin (oy, ox) and static
    window size (th, tw)."""
    th, tw = size
    oy, ox = origin
    xs = planar_axis_dyn(width, extent.x0, extent.x1, bias[0], tw, ox,
                         dtype)
    ys = planar_axis_dyn(height, extent.y0, extent.y1, bias[1], th, oy,
                         dtype)
    px = jnp.broadcast_to(xs[None, :], (th, tw))
    py = jnp.broadcast_to(ys[:, None], (th, tw))
    return px, py


def target_rays_dyn(projection: Projection, width: int, height: int,
                    extent, size, origin,
                    basis=None, normalize=True,
                    planar_to_ray=None, bias=(0.0, 0.0)):
    """target_rays with a traced window origin (for tile-granular
    fallback rendering)."""
    px, py = planar_grid_dyn(width, height, extent, size, origin, bias)
    if planar_to_ray is not None:
        ray = planar_to_ray(px, py)
    elif projection in (Projection.CUBEMAP, Projection.BIATAN6):
        rows = (jnp.arange(size[0])[:, None] + origin[0])
        rows = jnp.broadcast_to(rows, px.shape)
        ray = _cubemap_target_rays(projection, width, height, extent,
                                   px, py, rows)
    else:
        ray = geo.to_ray(projection)(px, py)
    if basis is not None:
        ray = geo.apply_matrix(basis, *ray)
    if normalize:
        ray = geo.normalize(*ray)
    return ray


def planar_grid(width: int, height: int, extent, bias=(0.0, 0.0),
                dtype=np.float32, window=None):
    """SoA planar coordinate grid (px, py), each (H, W) (or the window's
    shape if ``window=(y0, y1, x0, x1)`` in discrete pixels is given -
    the analogue of the reference's bill limits/offsets).

    ``bias`` entries may be traced scalars: the grid is then built at
    zero bias (host float64) and the bias offsets are added on-trace -
    one compiled program serves every sub-pixel tap position."""
    if not all(isinstance(b, (int, float)) for b in bias):
        px, py = planar_grid(width, height, extent, (0.0, 0.0), dtype,
                             window)
        step_x = (extent.x1 - extent.x0) / width
        step_y = (extent.y1 - extent.y0) / height
        return (px + bias[0] * dtype(step_x),
                py + bias[1] * dtype(step_y))
    if window is not None:
        y0, y1, x0, x1 = window
        xs = planar_axis(width, extent.x0, extent.x1, bias[0], dtype,
                         x0, x1)
        ys = planar_axis(height, extent.y0, extent.y1, bias[1], dtype,
                         y0, y1)
    else:
        xs = planar_axis(width, extent.x0, extent.x1, bias[0], dtype)
        ys = planar_axis(height, extent.y0, extent.y1, bias[1], dtype)
    px = jnp.broadcast_to(jnp.asarray(xs)[None, :], (ys.size, xs.size))
    py = jnp.broadcast_to(jnp.asarray(ys)[:, None], (ys.size, xs.size))
    return px, py


def _cubemap_target_rays(projection, width, height, extent, px, py,
                         row_index):
    """Cubemap/biatan6 targets: the face is determined by the integer
    row (iy // width, stepper.h:1289), which is robust at section
    boundaries; in-face coordinates come from the planar grid."""
    section_md = extent.x1 - extent.x0
    refc_md = section_md / 2.0
    face = (row_index // width).astype(jnp.int32)
    p1 = py + (3.0 - face.astype(py.dtype)) * section_md - refc_md
    p0 = px
    if projection == Projection.BIATAN6:
        p0 = jnp.tan(p0 * (math.pi / 4.0))
        p1 = jnp.tan(p1 * (math.pi / 4.0))
    return geo.in_face_to_ray(face, p0, p1)


def _separable_target_rays(projection, width, height, extent, bias,
                           window):
    """Spherical/cylindrical targets factor into per-axis terms
    (ll_to_ray = outer products of sincos(lon) and sincos(lat)): the
    transcendentals run host-side in float64 on the two 1D axes and
    the device graph only sees broadcast multiplies - the analogue
    of the reference steppers' row-invariant sincos tricks
    (stepper.h:520-707)."""
    y0, y1, x0, x1 = (0, height, 0, width) if window is None \
        else window
    xs = planar_axis(width, extent.x0, extent.x1, bias[0],
                     np.float64, x0, x1)
    ys = planar_axis(height, extent.y0, extent.y1, bias[1],
                     np.float64, y0, y1)
    shape = (ys.size, xs.size)
    col = lambda a: jnp.asarray(a.astype(np.float32))[None, :]
    row = lambda a: jnp.asarray(a.astype(np.float32))[:, None]
    if projection == Projection.SPHERICAL:
        sl, cl = col(np.sin(xs)), col(np.cos(xs))
        st, ct = row(np.sin(ys)), row(np.cos(ys))
        return (jnp.broadcast_to(sl * ct, shape),
                jnp.broadcast_to(st, shape),
                jnp.broadcast_to(cl * ct, shape))
    # cylindrical: (sin(az), y, cos(az))
    return (jnp.broadcast_to(col(np.sin(xs)), shape),
            jnp.broadcast_to(row(ys), shape),
            jnp.broadcast_to(col(np.cos(xs)), shape))


def target_rays(projection: Projection, width: int, height: int, extent,
                basis: Optional[np.ndarray] = None,
                normalize: bool = True,
                bias=(0.0, 0.0),
                dtype=np.float32,
                planar_to_ray: Optional[Callable] = None,
                window=None):
    """Rays for every pixel of the target raster, in the coordinate
    system selected by ``basis`` (3x3 host matrix; None = target CS).

    ``planar_to_ray`` overrides the projection-based transform - the
    'generic stepper' case (stepper.h:356-490) where lens correction /
    translation chains replace the plain projection."""
    if (planar_to_ray is None and dtype == np.float32
            and projection in (Projection.SPHERICAL,
                               Projection.CYLINDRICAL)
            and all(isinstance(b, (int, float)) for b in bias)):
        ray = _separable_target_rays(projection, width, height,
                                     extent, bias, window)
        if basis is not None:
            ray = geo.apply_matrix(basis, *ray)
        if normalize:
            ray = geo.normalize(*ray)
        return ray
    px, py = planar_grid(width, height, extent, bias, dtype, window)
    if planar_to_ray is not None:
        ray = planar_to_ray(px, py)
    elif projection in (Projection.CUBEMAP, Projection.BIATAN6):
        y_lo = 0 if window is None else window[0]
        rows = jnp.arange(y_lo, y_lo + px.shape[0])[:, None]
        rows = jnp.broadcast_to(rows, px.shape)
        ray = _cubemap_target_rays(projection, width, height, extent,
                                   px, py, rows)
    else:
        ray = geo.to_ray(projection)(px, py)
    if basis is not None:
        ray = geo.apply_matrix(basis, *ray)
    if normalize:
        ray = geo.normalize(*ray)
    return ray


def target_ninepack(projection, width, height, extent,
                    basis=None, normalize=True, dtype=np.float32,
                    planar_to_ray=None, window=None):
    """The three ray grids for twining: center, +bias_x, +bias_y
    (deriv_stepper, stepper.h:1587-1715)."""
    mk = lambda b: target_rays(projection, width, height, extent, basis,
                               normalize, b, dtype, planar_to_ray, window)
    return mk((0.0, 0.0)), mk((DERIV_BIAS, 0.0)), mk((0.0, DERIV_BIAS))
