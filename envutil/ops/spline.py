"""2D b-spline containers and evaluation on the device.

The equivalent of the reference's b-spline stack
(zimt/bspline.h, zimt/prefilter.h, zimt/eval.h, zimt/map.h, and the
spherical prefilter in environment.h:356-522):

* ``prefilter`` turns image data into spline coefficients via a
  separable FIR convolution with the exact (truncated) inverse spline
  filter over a boundary-extended signal - see ops/basis.py for why
  this replaces the reference's recursive filter.
* ``Spline2D`` holds *braced* coefficients: the core plus a physical
  support frame filled according to the boundary conditions (the
  reference's 'brace', zimt/bspline.h:311-438), so evaluation is a pure
  gather without conditionals.
* ``eval_spline`` evaluates with the weight-matrix formulation
  (zimt/eval.h:513-1666): gate the coordinate (zimt/map.h), split into
  cell index + fraction, form (degree+1) weights per axis, gather the
  (degree+1)^2 coefficient window and reduce.

Images are (H, W, C) arrays; coordinates are SoA pairs (x, y) in spline
units (0 .. M-1 across knots).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from . import basis as _basis

# boundary condition codes (subset of zimt/common.h:72-82 that the
# renderer uses)
MIRROR = "mirror"      # whole-point reflection: x[-1] == x[1]
REFLECT = "reflect"    # half-point reflection: x[-1] == x[0]
PERIODIC = "periodic"
NATURAL = "natural"    # point-mirrored continuation: x[-i] = 2x[0]-x[i]
CONSTANT = "constant"  # clamp / edge replication
ZEROPAD = "zero"

# extra brace rows/columns beyond the evaluation half-width: a margin
# that keeps every tap of a coordinate slightly outside the gated range
# (ungated cubemap pickups, rounding at the gate limits) on braced data,
# since eval_spline clamps its indices instead of checking them
EXTRA_BRACE = 2


def extend_axis(a: jnp.ndarray, axis: int, lo: int, hi: int,
                bc: str) -> jnp.ndarray:
    """Extend ``a`` along ``axis`` by ``lo``/``hi`` samples according to
    the boundary condition. This is both the signal extension ahead of
    prefiltering and the coefficient 'brace'."""
    if lo == 0 and hi == 0:
        return a
    n = a.shape[axis]

    def take(idx):
        idx = np.asarray(idx)
        return jnp.take(a, jnp.asarray(idx), axis=axis)

    if bc == PERIODIC:
        idx = np.mod(np.arange(-lo, n + hi), n)
        return take(idx)
    if bc == MIRROR:
        if n == 1:
            idx = np.zeros(lo + hi + 1, dtype=int)
            return take(idx)
        period = 2 * n - 2
        idx = np.abs(np.mod(np.arange(-lo, n + hi) + period, period))
        idx = np.where(idx >= n, period - idx, idx)
        return take(idx)
    if bc == REFLECT:
        period = 2 * n
        idx = np.mod(np.arange(-lo, n + hi) + period, period)
        idx = np.where(idx >= n, period - 1 - idx, idx)
        return take(idx)
    if bc == CONSTANT:
        idx = np.clip(np.arange(-lo, n + hi), 0, n - 1)
        return take(idx)
    if bc == ZEROPAD:
        pads = [(0, 0)] * a.ndim
        pads[axis] = (lo, hi)
        return jnp.pad(a, pads)
    if bc == NATURAL:
        # x[-i] = 2 x[0] - x[i]; x[n-1+i] = 2 x[n-1] - x[n-1-i]
        head_idx = np.clip(np.arange(lo, 0, -1), 0, n - 1)
        tail_idx = np.clip(n - 2 - np.arange(hi), 0, n - 1)
        first = jnp.take(a, jnp.asarray([0]), axis=axis)
        last = jnp.take(a, jnp.asarray([n - 1]), axis=axis)
        head = 2.0 * first - take(head_idx)
        tail = 2.0 * last - take(tail_idx)
        return jnp.concatenate([head, a, tail], axis=axis)
    raise ValueError(f"unknown boundary condition {bc!r}")


def _convolve_axis(a: jnp.ndarray, axis: int, kernel: np.ndarray
                   ) -> jnp.ndarray:
    """'valid' correlation of ``a`` with a symmetric 1D kernel along
    ``axis``, via lax.conv. The precision is pinned to HIGHEST: the GPU
    may otherwise run a float32 convolution in TF32 (about three
    decimal digits), and every spline coefficient would carry that
    error."""
    k = kernel.size
    if k == 1:
        return a * float(kernel[0])
    moved = jnp.moveaxis(a, axis, -1)
    shp = moved.shape
    lhs = moved.reshape((-1, 1, shp[-1]))  # (N, C=1, W)
    rhs = jnp.asarray(kernel[::-1].copy(), dtype=a.dtype).reshape(1, 1, k)
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(1,), padding="VALID",
        dimension_numbers=("NCW", "OIW", "NCW"),
        precision=jax.lax.Precision.HIGHEST)
    out = out.reshape(shp[:-1] + (shp[-1] - k + 1,))
    return jnp.moveaxis(out, -1, axis)


def prefilter_axis(a: jnp.ndarray, axis: int, degree: int, bc: str
                   ) -> jnp.ndarray:
    """Spline prefilter along one axis (output shape == input shape)."""
    kernel = _basis.inverse_kernel(degree)
    if kernel.size == 1:
        return a
    half = kernel.size // 2
    ext = extend_axis(a, axis, half, half, bc)
    return _convolve_axis(ext, axis, kernel)


def prefilter(a: jnp.ndarray, degree: int, bcs) -> jnp.ndarray:
    """Separable spline prefilter over the leading ndim-1 axes of an
    (H, W, C) array (or all axes of a channel-less array if bcs says
    so). ``bcs`` is a sequence of boundary codes, one per filtered axis
    (axis 0 = y first, axis 1 = x)."""
    out = a
    for axis, bc in enumerate(bcs):
        out = prefilter_axis(out, axis, degree, bc)
    return out


def spherical_prefilter(a: jnp.ndarray, degree: int) -> jnp.ndarray:
    """Mathematically correct prefilter for full-spherical (2:1
    equirect) images, reference environment.h:356-522.

    Horizontally the image is periodic. Vertically, periodicity holds
    along great circles through the poles: the continuation of a column
    x beyond the pole is column x + W/2 running in the opposite
    direction. Stacking the left half and the vertically flipped right
    half yields a signal that is truly periodic vertically; we filter
    that stack, then unstack. a is (H, W, C) with even W."""
    h, w = a.shape[0], a.shape[1]
    out = prefilter_axis(a, 1, degree, PERIODIC)
    if degree > 1:
        assert w % 2 == 0, "full spherical needs even width"
        left = out[:, : w // 2]
        right = out[::-1, w // 2:]
        stack = jnp.concatenate([left, right], axis=0)  # (2H, W/2, C)
        stack = prefilter_axis(stack, 0, degree, PERIODIC)
        left = stack[:h]
        right = stack[h:][::-1]
        out = jnp.concatenate([left, right], axis=1)
    return out


def spherical_brace(c: jnp.ndarray, pad_y: int, pad_x: int) -> jnp.ndarray:
    """Brace for full sphericals: periodic horizontally, over-the-pole
    vertically (row -1-k of column x equals row k of column
    (x + W/2) mod W; same at the bottom). Reference environment.h:449-516.

    The general index map: stacking a column with its W/2-rolled,
    flipped counterpart gives a 2H-periodic signal, so output row r maps
    to s = mod(r, 2H); s < H reads row s unrolled, s >= H reads row
    2H-1-s from the rolled image."""
    h, w = c.shape[0], c.shape[1]
    if pad_y:
        rows = np.arange(-pad_y, h + pad_y)
        s = np.mod(rows, 2 * h)
        row_idx = np.where(s < h, s, 2 * h - 1 - s)
        use_roll = s >= h
        plain = jnp.take(c, jnp.asarray(row_idx), axis=0)
        rolled = jnp.take(jnp.roll(c, w // 2, axis=1),
                          jnp.asarray(row_idx), axis=0)
        mask = jnp.asarray(use_roll).reshape((-1,) + (1,) * (c.ndim - 1))
        c = jnp.where(mask, rolled, plain)
    if pad_x:
        c = extend_axis(c, 1, pad_x, pad_x, PERIODIC)
    return c


# ---------------------------------------------------------------------------
# gates (zimt/map.h) - map continuous coordinates into the defined range
# ---------------------------------------------------------------------------

def gate(c, bc: str, n: int):
    """Map coordinate c into the spline's defined range for extent n
    under boundary condition bc (zimt/eval.h:2003-2031: PERIODIC ->
    periodic gate, MIRROR/REFLECT -> mirror gate, else clamp; limits
    from zimt/bspline.h:233-268: REFLECT/PERIODIC use [-0.5, n-0.5],
    others [0, n-1])."""
    if bc in (REFLECT, PERIODIC):
        lower, upper = -0.5, n - 0.5
    else:
        lower, upper = 0.0, float(n - 1)
    if n == 1:
        return jnp.zeros_like(c)
    if bc == PERIODIC:
        return lower + jnp.mod(c - lower, upper - lower)
    if bc in (MIRROR, REFLECT):
        period = 2.0 * (upper - lower)
        t = jnp.mod(c - lower, period)
        t = jnp.minimum(t, period - t)
        return lower + t
    return jnp.clip(c, lower, upper)


# ---------------------------------------------------------------------------
# spline container + evaluation
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Spline2D:
    """Braced 2D spline coefficients over an (H, W, C) image.

    ``coeff`` has shape (H + 2*pad, W + 2*pad, C); the core starts at
    (pad, pad). ``degree`` is the evaluation degree; ``bcs`` the
    (y, x) boundary codes used for gating."""

    coeff: jnp.ndarray
    pad: int
    degree: int
    bcs: tuple
    core_shape: tuple
    spherical: bool = False   # built with the over-the-pole brace

    def tree_flatten(self):
        return (self.coeff,), (self.pad, self.degree, self.bcs,
                               self.core_shape, self.spherical)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], *aux)


def make_spline(image: jnp.ndarray, spline_degree: int,
                prefilter_degree: int | None = None,
                bcs=(REFLECT, REFLECT),
                spherical: bool = False) -> Spline2D:
    """Build a braced, prefiltered spline over (H, W, C) image data.

    ``prefilter_degree`` may differ from ``spline_degree`` (the
    reference's --prefilter vs --degree, e.g. prefilter 0 + degree 3
    gives b-spline smoothing). ``spherical`` selects the special
    full-spherical treatment (PERIODIC horizontal + over-the-pole
    vertical continuation)."""
    if prefilter_degree is None:
        prefilter_degree = spline_degree
    pad = max(_basis.eval_half_width(spline_degree),
              _basis.eval_half_width(prefilter_degree)) + EXTRA_BRACE
    if spherical:
        c = spherical_prefilter(image, prefilter_degree)
        c = spherical_brace(c, pad, pad)
        bcs = (REFLECT, PERIODIC)  # gating only; brace is special
    else:
        c = prefilter(image, prefilter_degree, bcs)
        c = extend_axis(c, 0, pad, pad, bcs[0])
        c = extend_axis(c, 1, pad, pad, bcs[1])
    return Spline2D(coeff=c, pad=pad, degree=spline_degree,
                    bcs=tuple(bcs), core_shape=image.shape[:2],
                    spherical=spherical)


def make_spline_from_coeffs(coeffs: jnp.ndarray, spline_degree: int,
                            bcs=(REFLECT, REFLECT)) -> Spline2D:
    """Wrap already-computed spline coefficients (e.g. the per-section
    prefiltered cubemap IR) in a braced Spline2D without prefiltering."""
    pad = _basis.eval_half_width(spline_degree) + EXTRA_BRACE
    c = extend_axis(coeffs, 0, pad, pad, bcs[0])
    c = extend_axis(c, 1, pad, pad, bcs[1])
    return Spline2D(coeff=c, pad=pad, degree=spline_degree,
                    bcs=tuple(bcs), core_shape=coeffs.shape[:2])


def split(c, degree: int):
    """Split a gated spline coordinate into cell index (int32) and
    fraction, following the even/odd convention (zimt/eval.h:595-610):
    odd degrees: select = floor(c), t in [0, 1);
    even degrees: select = round(c), t in [-0.5, 0.5)."""
    if degree % 2:
        sel = jnp.floor(c)
    else:
        sel = jnp.floor(c + 0.5)
    return sel.astype(jnp.int32), c - sel


def _weights(t, degree: int):
    """(degree+1) evaluation weights from the fraction t, via the
    polynomial weight matrix (Horner form)."""
    m = _basis.weight_matrix(degree)
    ws = []
    for j in range(degree + 1):
        acc = jnp.full_like(t, float(m[j, degree]))
        for k in range(degree - 1, -1, -1):
            acc = acc * t + float(m[j, k])
        ws.append(acc)
    return ws


def eval_spline(spl: Spline2D, x, y, apply_gate: bool = True):
    """Evaluate the spline at continuous spline coordinates (x, y)
    (in knot units: 0..W-1 / 0..H-1). Returns an array shaped
    x.shape + (C,). Out-of-range coordinates are mapped by the gates
    (safe evaluator semantics, zimt/eval.h:2345)."""
    h, w = spl.core_shape
    n = spl.degree
    if apply_gate:
        x = gate(x, spl.bcs[1], w)
        y = gate(y, spl.bcs[0], h)
    sx, tx = split(x, n)
    sy, ty = split(y, n)
    wx = _weights(tx, n)
    wy = _weights(ty, n)

    hp, wp, ch = spl.coeff.shape
    flat = spl.coeff.reshape(hp * wp, ch)
    # base index of the coefficient window in the padded array
    bx = sx + (spl.pad - n // 2)
    by = sy + (spl.pad - n // 2)

    out = None
    for j in range(n + 1):
        row = (by + j) * wp
        # accumulate the row sum in x first, then weight by wy[j]
        row_acc = None
        for k in range(n + 1):
            idx = row + (bx + k)
            tap = jnp.take(flat, idx.reshape(-1), axis=0, mode="clip")
            tap = tap.reshape(idx.shape + (ch,))
            term = wx[k][..., None] * tap
            row_acc = term if row_acc is None else row_acc + term
        term = wy[j][..., None] * row_acc
        out = term if out is None else out + term
    return out
