"""Facet loading: image file(s) -> FacetSource (device-resident,
prefiltered spline + static lookup config), with asset caching.

This is the load half of the reference's environment construction
(environment.h:1552-1766 + source_t ctor + cubemap_t::load): cubemap /
biatan6 facets build the IR spline, everything else a mount source.
"""

from __future__ import annotations

import numpy as np

from ..core.conventions import FACE_NAMES, Projection
from ..core.facet import Facet
from ..io import imgio
from ..models import cubemap as CBM
from ..models import environment as E
from . import assets


def _read_facet_image(fct: Facet, args) -> np.ndarray:
    """Read the facet's pixel data (single file or %s cubeface series,
    envutil_basic.h:265-356) in the working colour space."""
    if "%s" in fct.filename:
        faces = [imgio.read_image(
            fct.filename % name, fct.colour_space,
            args.working_colour_space, args.verbose,
            oiio_options=args.oiio_options)
            for name in FACE_NAMES]
        return np.stack(faces)  # (6, F, F, C)
    img = imgio.read_image(fct.filename, fct.colour_space,
                           args.working_colour_space, args.verbose,
                           oiio_options=args.oiio_options)
    return img


def _decimate(img: np.ndarray, level: int) -> np.ndarray:
    """--twine_pyramid 2^level x 2^level box decimation of (H, W, C)
    pixel data. Box averaging preserves the edge-to-edge sample grid
    exactly: decimated pixel centers coincide with the centroids of
    the source blocks they replace (twine_setup already rewrote the
    facet's geometry to the decimated size)."""
    s = 1 << level
    h, w, c = img.shape
    assert h % s == 0 and w % s == 0, (img.shape, level)
    return img.reshape(h // s, s, w // s, s, c).mean(
        axis=(1, 3), dtype=np.float32)


def load_source(fct: Facet, args) -> E.FacetSource:
    """Build (or fetch from cache) the FacetSource for a facet."""
    # masking jobs without alpha need no image data (masking_t path,
    # environment.h:1585-1588 / source_t:658)
    if fct.masked != -1 and args.nchannels in (1, 3):
        return E.make_paint_source(fct)
    # solo jobs skip loading all but the solo facet... but their masks
    # are still consulted; geometry-only paint sources are not correct
    # there, so we only skip for facets that can never contribute.

    key = (fct.asset_key, args.spline_degree, args.prefilter_degree,
           fct.projection, args.nchannels if fct.masked != -1 else -1,
           getattr(args, "coeff_dtype", "f32"), fct.pyramid_level)
    cached = assets.cache.find(key)
    if cached is not None:
        if args.verbose:
            print(f"asset {fct.asset_key} is already present in RAM")
        # rebind the cached spline to this facet's static config (the
        # masked flag / brighten may differ between jobs)
        return _make_source_from(fct, args, cached)

    # durable miss path: the on-disk coefficient cache skips image
    # read + prefilter across process restarts
    from . import coeff_cache
    spl = coeff_cache.load(args, fct, key)
    if spl is not None:
        src = _make_source_from(fct, args, spl)
        _apply_coeff_dtype(src, args)
        assets.cache.add(key, src.spl)
        return src

    img = _read_facet_image(fct, args)
    if fct.pyramid_level > 0:
        img = _decimate(img, fct.pyramid_level)
    src = _build(fct, args, img)
    _apply_coeff_dtype(src, args)
    coeff_cache.store(args, fct, key, src.spl)
    assets.cache.add(key, src.spl)
    return src


def _apply_coeff_dtype(src: E.FacetSource, args) -> None:
    """--coeff bf16: store coefficient tables in bfloat16 (half the
    device-memory footprint and gather traffic; evaluation still runs
    in float32 after the gather). The accuracy cost is the bf16
    rounding of the coefficients (~8 mantissa bits, ~45 dB) - intended
    for sources whose float32 tables would not fit."""
    if getattr(args, "coeff_dtype", "f32") != "bf16":
        return
    import dataclasses as _dc

    import jax.numpy as jnp

    def cv(spl):
        return _dc.replace(spl, coeff=spl.coeff.astype(jnp.bfloat16))

    if src.spl is not None:
        src.spl = cv(src.spl)


def _build(fct: Facet, args, img: np.ndarray) -> E.FacetSource:
    if fct.projection in (Projection.CUBEMAP, Projection.BIATAN6):
        if img.ndim == 3:
            f = img.shape[1]
            assert img.shape[0] == 6 * f, \
                "cubemap input must be a 1:6 stripe or %s series"
            faces = img.reshape(6, f, f, img.shape[2])
        else:
            faces = img
        # the facet's width is the face width for cubemaps
        fct_face = fct
        fct_face.width = faces.shape[1]
        return CBM.make_cubemap_source(
            fct_face, faces, args.spline_degree, args.prefilter_degree,
            args.support_min, args.tile_size)
    return E.make_mount_source(fct, img, args.spline_degree,
                               args.prefilter_degree, args.verbose)


def _make_source_from(fct: Facet, args, spl) -> E.FacetSource:
    """Recreate the static config around a cached spline."""
    if fct.projection in (Projection.CUBEMAP, Projection.BIATAN6):
        # rebuild metrics-based static (cheap)
        from ..core.metrics import CubemapMetrics, get_extent
        m = CubemapMetrics.create(fct.width, fct.hfov, args.support_min,
                                  args.tile_size)
        static = E.SourceStatic(
            kind="cubemap", projection=fct.projection,
            total_extent=get_extent(fct.projection, fct.width,
                                    6 * fct.width, fct.hfov),
            window_extent=get_extent(fct.projection, fct.width,
                                     6 * fct.width, fct.hfov),
            total_width=fct.width, total_height=6 * fct.width,
            window_x_offset=0, window_y_offset=0,
            nch_native=spl.coeff.shape[-1], recip_step=1.0 / fct.step,
            brighten=fct.brighten, masked=fct.masked, metrics=m)
        return E.FacetSource(static=static, spl=spl)
    # mount: rebuild static without re-reading the image
    import math

    from ..core.metrics import Extent, get_extent
    total_extent = get_extent(fct.projection, fct.width, fct.height,
                              fct.hfov)
    wx = total_extent.x1 - total_extent.x0
    wy = total_extent.y1 - total_extent.y0
    x0 = total_extent.x0 + (fct.window_x_offset / fct.width) * wx
    y0 = total_extent.y0 + (fct.window_y_offset / fct.height) * wy
    x1 = total_extent.x0 + ((fct.window_x_offset + fct.window_width)
                            / fct.width) * wx
    y1 = total_extent.y0 + ((fct.window_y_offset + fct.window_height)
                            / fct.height) * wy
    static = E.SourceStatic(
        kind="mount", projection=fct.projection,
        total_extent=total_extent,
        window_extent=Extent(x0, x1, y0, y1),
        total_width=fct.width, total_height=fct.height,
        window_x_offset=fct.window_x_offset,
        window_y_offset=fct.window_y_offset,
        nch_native=spl.coeff.shape[-1], recip_step=1.0 / fct.step,
        brighten=fct.brighten, masked=fct.masked,
        full_fisheye=(fct.projection == Projection.FISHEYE
                      and fct.hfov >= 2.0 * math.pi),
        has_lcp=fct.has_lcp, has_shift=fct.has_shift,
        has_shear=fct.has_shear, a=fct.a, b=fct.b, c=fct.c, s=fct.s,
        h=fct.h, v=fct.v, shear_g=fct.shear_g, shear_t=fct.shear_t)
    return E.FacetSource(static=static, spl=spl)
