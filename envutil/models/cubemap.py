"""Cubemap internal representation (IR) builder.

The IR is a 1:6 vertical stripe of six square 'sections', each a cube
face image centered in a frame of support pixels, so that any ray can
be resolved with a single spline evaluation without crossing face
boundaries (reference: cubemap.h:517-1277, metrics.h).

Construction (cubemap_t::load + fill_support, cubemap.h:819-946),
redesigned as array passes:

1. place the six face images into the stripe,
2. 'mirror around': 1-px edge replication around each face so the
   support fill never reads black (cubemap.h:607-659),
3. fill the support frames by re-projecting from adjoining faces -
   a single vectorized pass: frame pixel -> ray -> cube face ->
   bilinear pickup (cubemap.h:687-911),
4. prefilter each section separately with NATURAL boundaries
   (cubemap.h:921-946) - batched over the 6 sections,
5. brace the whole stripe (REFLECT) for evaluation.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core import geometry as geo
from ..core.conventions import Projection
from ..core.facet import Facet
from ..core.metrics import CubemapMetrics, get_extent
from ..ops import spline as S
from .environment import FacetSource, SourceStatic


def _mirror_around(ir: jnp.ndarray, m: CubemapMetrics) -> jnp.ndarray:
    """1-px edge replication around each cube face inside its section
    (cubemap.h:607-659). ir is (6S, S, C)."""
    if m.left_frame_px == 0 and m.right_frame_px == 0:
        return ir
    s, f, lf = m.section_px, m.face_px, m.left_frame_px
    sec = ir.reshape(6, s, s, -1)
    face = sec[:, lf:lf + f, lf:lf + f]
    lo, hi = (1 if m.left_frame_px else 0), (1 if m.right_frame_px else 0)
    framed = S.extend_axis(face, 1, lo, hi, S.CONSTANT)
    framed = S.extend_axis(framed, 2, lo, hi, S.CONSTANT)
    sec = sec.at[:, lf - lo:lf + f + hi, lf - lo:lf + f + hi].set(framed)
    return sec.reshape(6 * s, s, -1)


def fill_support(ir: jnp.ndarray, m: CubemapMetrics) -> jnp.ndarray:
    """Populate the support frames by re-projecting content from the
    adjoining cube faces (cubemap.h:819-911). One vectorized pass over
    the whole stripe; face-interior pixels keep their original values."""
    if m.left_frame_px == 0 and m.right_frame_px == 0:
        return ir
    ir = _mirror_around(ir, m)
    s, f, lf = m.section_px, m.face_px, m.left_frame_px

    # bilinear evaluator over the stripe with its 1-px mirrored frames
    ev = S.make_spline_from_coeffs(ir, 1, (S.REFLECT, S.REFLECT))

    # in-section pixel centers in model units relative to the section
    # center (the reference's doubled-int linspace divided out)
    i = np.arange(s, dtype=np.float64)
    mm = (i - (s - 1) / 2.0) * m.px_to_model
    mx = jnp.asarray(np.broadcast_to(mm[None, :], (s, s)), jnp.float32)
    my = jnp.asarray(np.broadcast_to(mm[:, None], (s, s)), jnp.float32)

    sections = []
    for face in range(6):
        ray = geo.in_face_to_ray(jnp.full((s, s), face, jnp.int32), mx, my)
        fv, fx, fy = geo.ray_to_cubeface(*ray)
        cx, cy = m.get_pickup_coordinate_px(fv, fx, fy)
        filled = S.eval_spline(ev, cx, cy, apply_gate=False)
        sections.append(filled)
    filled = jnp.concatenate(sections, axis=0)  # (6S, S, C)

    # static mask: True inside the cube faces proper
    inface_1d = (np.arange(s) >= lf) & (np.arange(s) < lf + f)
    keep = np.tile(inface_1d[:, None] & inface_1d[None, :], (6, 1))
    keep = jnp.asarray(keep)[..., None]
    return jnp.where(keep, ir, filled)


def build_ir_spline(faces: jnp.ndarray, m: CubemapMetrics,
                    spline_degree: int, prefilter_degree: int
                    ) -> S.Spline2D:
    """faces: (6, F, F, C) float32 in LEFT,RIGHT,TOP,BOTTOM,FRONT,BACK
    order -> braced spline over the (6S, S, C) IR stripe."""
    six, f, _, c = faces.shape
    assert six == 6 and f == m.face_px
    s, lf = m.section_px, m.left_frame_px
    ir = jnp.zeros((6, s, s, c), faces.dtype)
    ir = ir.at[:, lf:lf + f, lf:lf + f].set(faces)
    ir = ir.reshape(6 * s, s, c)
    ir = fill_support(ir, m)
    if prefilter_degree > 1:
        sec = ir.reshape(6, s, s, c)
        sec = S.prefilter_axis(sec, 1, prefilter_degree, S.NATURAL)
        sec = S.prefilter_axis(sec, 2, prefilter_degree, S.NATURAL)
        ir = sec.reshape(6 * s, s, c)
    return S.make_spline_from_coeffs(ir, spline_degree,
                                     (S.REFLECT, S.REFLECT))


def make_cubemap_source(fct: Facet, faces: np.ndarray, spline_degree: int,
                        prefilter_degree: int, support_min: int,
                        tile_size: int) -> FacetSource:
    """Build a FacetSource for a cubemap/biatan6 facet from its six
    face images (the _environment cubemap path, environment.h:1559-1677)."""
    m = CubemapMetrics.create(fct.width, fct.hfov, support_min, tile_size)
    spl = build_ir_spline(jnp.asarray(faces, jnp.float32), m,
                          spline_degree, prefilter_degree)
    static = SourceStatic(
        kind="cubemap", projection=fct.projection,
        total_extent=get_extent(fct.projection, fct.width,
                                6 * fct.width, fct.hfov),
        window_extent=get_extent(fct.projection, fct.width,
                                 6 * fct.width, fct.hfov),
        total_width=fct.width, total_height=6 * fct.width,
        window_x_offset=0, window_y_offset=0,
        nch_native=faces.shape[-1], recip_step=1.0 / fct.step,
        brighten=fct.brighten, masked=fct.masked, metrics=m)
    return FacetSource(static=static, spl=spl)

