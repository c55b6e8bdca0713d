"""Facet 'environments': ray -> pixel lookup functors over loaded
image data.

A redesign of the reference's environment.h: a facet becomes a
``FacetSource`` - a pytree whose dynamic leaves are the prefiltered
spline coefficients (jit arguments, so renders re-use one compiled
program across images of the same shape) and whose static part
(``SourceStatic``) is a hashable config that specializes the traced
code, playing the role the reference's template parameters play
(mount_t<C,P,L>, cubemap_view_t, masking_t).

Lookup semantics mirror:
  * mount_t (environment.h:1030-1197): ray -> planar (per projection),
    optional PTO planar transform, window-extent validity mask (+z>0
    for rectilinear), miss -> 0.
  * cubemap_view_t (environment.h:1396-1488): ray -> cube face +
    in-face -> IR pickup -> spline eval, biatan6 in-plane atan.
  * masking_t / alpha_masking_t (masking.h:74,93) for --mask_for jobs.
  * repix_t / mono_t channel adaptation (environment.h:1199-1384).
  * per-facet 'brighten' on non-alpha channels (environment.h:1821-1842)
    and the 'recip_step' quality factor for the voronoi criterion.

Image loading / alpha synthesis (PTO masks, lens crop, feathering) is
host-side numpy at configuration time (source_t ctor,
environment.h:594-962); prefiltering runs as a jitted device op.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import geometry as geo
from ..core.conventions import Projection
from ..core.facet import Facet
from ..core.metrics import CubemapMetrics, Extent, get_extent
from ..ops import spline as S
from . import lens as L


@dataclasses.dataclass(frozen=True)
class SourceStatic:
    """Hashable per-facet configuration baked into the traced render."""
    kind: str                      # "mount" | "cubemap" | "paint"
    projection: Projection
    total_extent: Extent
    window_extent: Extent
    total_width: int
    total_height: int
    window_x_offset: int
    window_y_offset: int
    nch_native: int
    recip_step: float
    brighten: float
    masked: int = -1
    full_fisheye: bool = False
    # PTO planar transform (target->source direction)
    has_lcp: bool = False
    has_shift: bool = False
    has_shear: bool = False
    a: float = 0.0
    b: float = 0.0
    c: float = 0.0
    s: float = 1.0
    h: float = 0.0
    v: float = 0.0
    shear_g: float = 0.0
    shear_t: float = 0.0
    # cubemap IR
    metrics: Optional[CubemapMetrics] = None


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class FacetSource:
    static: SourceStatic
    spl: Optional[S.Spline2D]

    def tree_flatten(self):
        return (self.spl,), self.static

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(aux, children[0])


# ---------------------------------------------------------------------------
# host-side construction
# ---------------------------------------------------------------------------

def _fill_polygon_mask(alpha: np.ndarray, vx, vy) -> None:
    """Scanline polygon fill with winding order, setting covered pixels
    to 0 - panotools-compatible (self-intersections filled), same
    algorithm family as envutil_basic.cc:236-321."""
    h, w = alpha.shape
    vx = np.asarray(vx, np.float64)
    vy = np.asarray(vy, np.float64)
    n = vx.size
    if n < 3:
        return
    for y in range(int(max(0, math.floor(vy.min()))),
                   int(min(h, math.ceil(vy.max()) + 1))):
        nodes = []
        j = n - 1
        for i in range(n):
            cross = 0
            if vy[i] < y and vy[j] >= y:
                cross = 1
            elif vy[j] < y and vy[i] >= y:
                cross = -1
            if cross:
                # the reference truncates the crossing x to int before
                # sorting (envutil_basic.cc:266); its bubble sort keeps
                # equal keys in insertion order, so sort stably on x
                x = vx[i] + (y - vy[i]) / (vy[j] - vy[i]) * (vx[j] - vx[i])
                nodes.append((int(x), cross))
            j = i
        nodes.sort(key=lambda t: t[0])
        # cumulative winding over the sorted crossings; fill between
        # node k and k+1 while it is nonzero. The crossings of a closed
        # polygon sum to zero per scanline, so the last node never
        # starts a filled span (the reference relies on the same).
        w_ord = 0
        for k in range(len(nodes) - 1):
            w_ord += nodes[k][1]
            if w_ord == 0:
                continue
            x0 = max(0, nodes[k][0])
            x1 = min(w, nodes[k + 1][0])
            if x0 < x1:
                alpha[y, x0:x1] = 0.0


def _binomial_blur(a: np.ndarray) -> np.ndarray:
    """Separable 5-tap binomial low-pass with REFLECT boundaries -
    feathers mask edges (environment.h:833-843)."""
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    for axis in range(2):
        idx = np.arange(-2, a.shape[axis] + 2)
        nn = a.shape[axis]
        idx = np.mod(idx, 2 * nn)
        idx = np.where(idx >= nn, 2 * nn - 1 - idx, idx)
        ext = np.take(a, idx, axis=axis)
        out = np.zeros_like(a)
        for t in range(5):
            out += k[t] * np.take(ext, np.arange(t, t + a.shape[axis]),
                                  axis=axis)
        a = out
    return a


def synthesize_alpha(img: np.ndarray, fct: Facet,
                     verbose: bool = False) -> np.ndarray:
    """Apply PTO exclude masks and lens cropping by alpha manipulation:
    add an alpha channel if absent, rasterize masks/crop, feather, and
    multiply into all channels (associated alpha).
    Reference: environment.h:727-890."""
    h, w, c = img.shape
    if c in (1, 3):
        img = np.concatenate([img, np.ones((h, w, 1), img.dtype)], axis=-1)
    alpha = np.ones((h, w), np.float32)

    if fct.has_pto_mask:
        if verbose:
            print("applying PTO 'exclude' masks")
        for mask in fct.pto_masks:
            if mask.variant == 0:
                _fill_polygon_mask(alpha, mask.vx, mask.vy)
            elif verbose:
                print(f"skipping PTO masks variant {mask.variant}")

    if fct.has_lens_crop:
        a = abs(fct.crop_x1 - fct.crop_x0) / 2.0
        b = abs(fct.crop_y1 - fct.crop_y0) / 2.0
        if fct.projection == Projection.FISHEYE:
            if verbose:
                print("applying elliptic crop")
            mx = (fct.crop_x0 + fct.crop_x1) / 2.0
            my = (fct.crop_y0 + fct.crop_y1) / 2.0
            ys = np.abs(np.arange(h) - my)[:, None]
            xs = np.abs(np.arange(w) - mx)[None, :]
            with np.errstate(invalid="ignore"):
                xmargin = np.sqrt(np.maximum(
                    a * a * (1.0 - (ys * ys) / (b * b)), 0.0))
            alpha[(ys > b) | (xs > xmargin)] = 0.0
        else:
            if verbose:
                print("applying rectangular crop")
            ys = np.arange(h)[:, None]
            xs = np.arange(w)[None, :]
            outside = ((xs < fct.crop_x0) | (xs >= fct.crop_x1)
                       | (ys < fct.crop_y0) | (ys >= fct.crop_y1))
            alpha[np.broadcast_to(outside, alpha.shape)] = 0.0

    alpha = _binomial_blur(alpha)
    return img * alpha[..., None]


def is_full_spherical(fct: Facet) -> bool:
    return (fct.projection == Projection.SPHERICAL
            and abs(fct.hfov - 2.0 * math.pi) < 1e-6
            and fct.width == 2 * fct.height)


def make_mount_source(fct: Facet, img: np.ndarray, spline_degree: int,
                      prefilter_degree: int,
                      verbose: bool = False) -> FacetSource:
    """source_t + mount_t construction (environment.h:594-962)."""
    assert img.ndim == 3, \
        f"mount source expects (H, W, C) pixel data, got {img.shape}"
    if fct.has_lens_crop or fct.has_pto_mask:
        img = synthesize_alpha(img, fct, verbose)
    nch = img.shape[-1]

    bc0 = S.REFLECT
    if fct.projection in (Projection.SPHERICAL, Projection.CYLINDRICAL):
        if abs(fct.hfov - 2.0 * math.pi) < 1e-6:
            bc0 = S.PERIODIC

    spherical = is_full_spherical(fct)
    if verbose:
        kind = "spherical" if spherical else "ordinary"
        print(f"applying {kind} b-spline prefilter, degree "
              f"{prefilter_degree}")
    spl = S.make_spline(jnp.asarray(img, jnp.float32), spline_degree,
                        prefilter_degree, bcs=(S.REFLECT, bc0),
                        spherical=spherical)

    total_extent = get_extent(fct.projection, fct.width, fct.height,
                              fct.hfov)
    # window extent for cropped input (source_t ctor,
    # environment.h:606-631 - note the reference derives both the x and
    # y fractions from total_width; we reproduce the y math faithfully
    # only when offsets are 0, and use the natural formula otherwise)
    wx = total_extent.x1 - total_extent.x0
    wy = total_extent.y1 - total_extent.y0
    x0 = total_extent.x0 + (fct.window_x_offset / fct.width) * wx
    y0 = total_extent.y0 + (fct.window_y_offset / fct.height) * wy
    x1 = total_extent.x0 + ((fct.window_x_offset + fct.window_width)
                            / fct.width) * wx
    y1 = total_extent.y0 + ((fct.window_y_offset + fct.window_height)
                            / fct.height) * wy
    window_extent = Extent(x0, x1, y0, y1)

    static = SourceStatic(
        kind="mount", projection=fct.projection,
        total_extent=total_extent, window_extent=window_extent,
        total_width=fct.width, total_height=fct.height,
        window_x_offset=fct.window_x_offset,
        window_y_offset=fct.window_y_offset,
        nch_native=nch, recip_step=1.0 / fct.step, brighten=fct.brighten,
        masked=fct.masked,
        full_fisheye=(fct.projection == Projection.FISHEYE
                      and fct.hfov >= 2.0 * math.pi),
        has_lcp=fct.has_lcp, has_shift=fct.has_shift,
        has_shear=fct.has_shear, a=fct.a, b=fct.b, c=fct.c, s=fct.s,
        h=fct.h, v=fct.v, shear_g=fct.shear_g, shear_t=fct.shear_t)
    return FacetSource(static=static, spl=spl)


def make_paint_source(fct: Facet) -> FacetSource:
    """--mask_for source without image data (masking_t, masking.h:74):
    paints the constant fct.masked where the facet covers."""
    total_extent = get_extent(fct.projection, fct.width, fct.height,
                              fct.hfov)
    static = SourceStatic(
        kind="paint", projection=fct.projection,
        total_extent=total_extent, window_extent=total_extent,
        total_width=fct.width, total_height=fct.height,
        window_x_offset=0, window_y_offset=0,
        nch_native=1, recip_step=1.0 / fct.step, brighten=fct.brighten,
        masked=fct.masked,
        full_fisheye=(fct.projection == Projection.FISHEYE
                      and fct.hfov >= 2.0 * math.pi))
    return FacetSource(static=static, spl=None)


# ---------------------------------------------------------------------------
# traced lookup
# ---------------------------------------------------------------------------

def _planar_transform(st: SourceStatic):
    """PTO planar transform in target->source direction, built from the
    static config (pto_planar, environment.h:259-284)."""
    if not (st.has_lcp or st.has_shift or st.has_shear):
        return None

    def f(px, py):
        if st.has_lcp:
            r = jnp.sqrt(px * px + py * py) / st.s
            factor = L.lcp_scale(r, st.a, st.b, st.c)
            px, py = px * factor, py * factor
        if st.has_shift:
            px, py = px + st.h, py + st.v
        if st.has_shear:
            nx = px + py * st.shear_g
            ny = py + px * st.shear_t
            px, py = nx, ny
        return px, py
    return f


def _mount_planar(st: SourceStatic, ray):
    crd = geo.to_plane(st.projection)(*ray)
    pf = _planar_transform(st)
    if pf is not None:
        crd = pf(*crd)
    return crd


def get_mask(src: FacetSource, ray):
    """Validity mask: does this ray hit the facet's data window?
    (mount_t::get_mask, environment.h:1156-1167; all-true for cubemaps
    and >=360-degree fisheyes, environment.h:1577,1751)."""
    st = src.static
    if st.kind == "cubemap" or st.full_fisheye:
        return jnp.ones(ray[0].shape, dtype=bool)
    px, py = _mount_planar(st, ray)
    we = st.window_extent
    mask = ((px >= we.x0) & (px <= we.x1)
            & (py >= we.y0) & (py <= we.y1))
    if st.projection == Projection.RECTILINEAR:
        mask = mask & (ray[2] > 0.0)
    return mask


def _md_to_spline(st: SourceStatic, px, py):
    """model-space planar -> spline coordinates
    (source_t::md_to_spline, environment.h:988-1006)."""
    te = st.total_extent
    ix = (px - te.x0) / (te.x1 - te.x0) * st.total_width - 0.5
    iy = (py - te.y0) / (te.y1 - te.y0) * st.total_height - 0.5
    return ix - st.window_x_offset, iy - st.window_y_offset


def source_spline_coords(src: FacetSource, ray):
    """Continuous spline coordinates (core units, ungated) and the
    validity mask for the given rays - the coordinate half of lookup(),
    shared with the ring-sharded evaluation (parallel/mesh.py)."""
    st = src.static
    if st.kind == "cubemap":
        face, fx, fy = geo.ray_to_cubeface(*ray)
        if st.projection == Projection.BIATAN6:
            fx = (4.0 / math.pi) * jnp.arctan(fx)
            fy = (4.0 / math.pi) * jnp.arctan(fy)
        cx, cy = st.metrics.get_pickup_coordinate_px(face, fx, fy)
        mask = jnp.ones(ray[0].shape, dtype=bool)
        return cx, cy, mask
    crd = _mount_planar(st, ray)
    mask = ((crd[0] >= st.window_extent.x0)
            & (crd[0] <= st.window_extent.x1)
            & (crd[1] >= st.window_extent.y0)
            & (crd[1] <= st.window_extent.y1))
    if st.projection == Projection.RECTILINEAR:
        mask = mask & (ray[2] > 0.0)
    sx, sy = _md_to_spline(st, *crd)
    return sx, sy, mask


def lookup(src: FacetSource, ray, nch_out: int,
           with_mask: bool = True):
    """Evaluate the facet at the given rays: returns (px, mask) where
    px has shape ray[0].shape + (nch_out,), misses painted to 0
    (associated alpha). This is the reference's environment::eval
    including channel adaptation and brighten."""
    st = src.static
    shape = ray[0].shape

    if st.kind == "paint" :
        # masking_t: constant paint where the facet covers
        mask = get_mask(src, ray)
        val = jnp.where(mask, float(st.masked), 0.0)
        px = jnp.repeat(val[..., None], nch_out, axis=-1)
        if nch_out in (2, 4):
            px = px.at[..., -1].set(jnp.where(mask, 1.0, 0.0))
        return px, mask

    if st.kind == "cubemap":
        face, fx, fy = geo.ray_to_cubeface(*ray)
        if st.projection == Projection.BIATAN6:
            fx = (4.0 / math.pi) * jnp.arctan(fx)
            fy = (4.0 / math.pi) * jnp.arctan(fy)
        cx, cy = st.metrics.get_pickup_coordinate_px(face, fx, fy)
        px = S.eval_spline(src.spl, cx, cy, apply_gate=False)
        mask = jnp.ones(shape, dtype=bool)
    else:
        crd = _mount_planar(st, ray)
        mask = ((crd[0] >= st.window_extent.x0)
                & (crd[0] <= st.window_extent.x1)
                & (crd[1] >= st.window_extent.y0)
                & (crd[1] <= st.window_extent.y1))
        if st.projection == Projection.RECTILINEAR:
            mask = mask & (ray[2] > 0.0)
        sx, sy = _md_to_spline(st, *crd)
        px = S.eval_spline(src.spl, sx, sy)
        if with_mask:
            px = jnp.where(mask[..., None], px, 0.0)

    if st.masked != -1:
        # alpha_masking_t (masking.h:93): paint masked * alpha
        alpha = px[..., -1:]
        paint = float(st.masked) * alpha
        px = jnp.concatenate([jnp.repeat(paint, max(nch_out - 1, 1),
                                         axis=-1), alpha], axis=-1)
        px = px[..., :nch_out]
        return px, mask

    px = repix(px, nch_out)
    if st.brighten != 1.0:
        px = apply_brighten(px, st.brighten)
    return px, mask


def repix(px, nch_out: int):
    """Channel-count adaptation (repix_t, environment.h:1205-1309).
    2- and 4-channel data carry associated alpha in the last channel."""
    nch_in = px.shape[-1]
    if nch_in == nch_out:
        return px
    one = jnp.ones_like(px[..., :1])

    def deassoc(c, a):
        return jnp.where(a == 0.0, 0.0, c / jnp.where(a == 0.0, 1.0, a))

    if nch_in == 1:
        g = px[..., :1]
        if nch_out == 2:
            return jnp.concatenate([g, one], -1)
        if nch_out == 3:
            return jnp.concatenate([g, g, g], -1)
        return jnp.concatenate([g, g, g, one], -1)
    if nch_in == 2:
        g, a = px[..., :1], px[..., 1:2]
        if nch_out == 1:
            return deassoc(g, a)
        if nch_out == 3:
            gg = deassoc(g, a)
            return jnp.concatenate([gg, gg, gg], -1)
        return jnp.concatenate([g, g, g, a], -1)
    if nch_in == 3:
        grey = jnp.mean(px, axis=-1, keepdims=True)
        if nch_out == 1:
            return grey
        if nch_out == 2:
            return jnp.concatenate([grey, one], -1)
        return jnp.concatenate([px, one], -1)
    # nch_in == 4
    a = px[..., 3:4]
    if nch_out == 1:
        return deassoc(jnp.mean(px[..., :3], axis=-1, keepdims=True), a)
    if nch_out == 2:
        return jnp.concatenate(
            [jnp.mean(px[..., :3], axis=-1, keepdims=True), a], -1)
    return deassoc(px[..., :3], a)


def apply_brighten(px, brighten: float):
    """Multiply non-alpha channels (environment.h:1821-1842)."""
    nch = px.shape[-1]
    if nch in (2, 4):
        colour = px[..., :nch - 1] * brighten
        return jnp.concatenate([colour, px[..., nch - 1:]], -1)
    return px * brighten


def apply_brighten_planar(px, brighten: float):
    """apply_brighten for channel-planes-first (C, H, W) data."""
    nch = px.shape[0]
    if nch in (2, 4):
        colour = px[:nch - 1] * brighten
        return jnp.concatenate([colour, px[nch - 1:]], 0)
    return px * brighten
