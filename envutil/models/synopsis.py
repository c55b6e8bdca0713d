"""Synopsis: composing pixels from several facets.

Re-designs of the reference's synopsis-forming objects
(envutil_payload.cc):

* ``voronoi``    - opaque panorama: the facet whose (normalized,
  facet-CS) ray has the largest z * recip_step wins - the 'champion'
  criterion (README.md:427-469, _voronoi_syn:762-957). The reference's
  per-batch fast paths (all-miss, unanimous champion) are control flow;
  here everything is one branchless argmax + select, which fuses into
  the render.
* ``voronoi_plus`` - facets with alpha: z-ordering of all facets per
  pixel (the reference trickle-up sorts SIMD lanes,
  _voronoi_syn_plus:964-1233; we sort along the facet axis) followed by
  front-to-back associated-alpha compositing.
* ``hdr_merge``  - exposure fusion with triangular quality weighting,
  max-of-RGB grey projection, darkest facet ruling highlights and
  brightest ruling shadows (_hdr_merge_syn:1325-1623).

Twining (the synopsis_t wrapper, envutil_payload.cc:587-691) is a
static loop over the spread coefficients: each tap deflects all
facets' rays along the differenced derivative rays and feeds the plain
synopsis; the weighted taps accumulate into the result. K is known at
trace time, so XLA fuses the whole loop.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from . import environment as E
from .stepper import DERIV_BIAS

_LOWEST = float(np.finfo(np.float32).min)


def _eval_all(sources: List[E.FacetSource], rays, nch: int):
    """Evaluate every facet at its rays; returns stacked pixels
    (NF, ..., C), masks (NF, ...), scores (NF, ...)."""
    pxs, masks, scores = [], [], []
    for src, ray in zip(sources, rays):
        px, mask = E.lookup(src, ray, nch)
        z = ray[2] * src.static.recip_step
        pxs.append(px)
        masks.append(mask)
        scores.append(jnp.where(mask, z, _LOWEST))
    return jnp.stack(pxs), jnp.stack(masks), jnp.stack(scores)


def voronoi_stack(px, mask, score):
    """Champion select from precomputed stacks: px (NF, ..., C),
    mask/score (NF, ...). The select is a static where-cascade over
    the (small) facet axis: an elementwise select that fuses into the
    render, where take_along_axis would add a data-dependent gather."""
    champion = jnp.argmax(score, axis=0)
    any_valid = jnp.any(mask, axis=0)
    sel = px[0]
    for f in range(1, px.shape[0]):
        sel = jnp.where((champion == f)[..., None], px[f], sel)
    return jnp.where(any_valid[..., None], sel, 0.0)


def voronoi_plus_stack(px, mask, score):
    """Z-ordered front-to-back associated-alpha compositing from
    precomputed stacks."""
    # rank via argsort of the (small, static) facet axis, then select
    # each depth layer with a where-cascade: no data gathers
    order = jnp.argsort(-score, axis=0)
    nf = px.shape[0]

    def layer(l):
        sel = px[0]
        vld = mask[0]
        for f in range(1, nf):
            hit = order[l] == f
            sel = jnp.where(hit[..., None], px[f], sel)
            vld = jnp.where(hit, mask[f], vld)
        return sel, vld

    sel0, vld0 = layer(0)
    acc = jnp.where(vld0[..., None], sel0, 0.0)
    for l in range(1, nf):
        sel_l, vld_l = layer(l)
        contrib = jnp.where(vld_l[..., None], sel_l, 0.0)
        acc = acc + (1.0 - acc[..., -1:]) * contrib
    return acc


def voronoi(sources, rays, nch: int):
    px, mask, score = _eval_all(sources, rays, nch)
    return voronoi_stack(px, mask, score)


def voronoi_plus(sources, rays, nch: int):
    px, mask, score = _eval_all(sources, rays, nch)
    return voronoi_plus_stack(px, mask, score)


def _grey_project(px):
    """max of R,G,B (envutil_payload.cc:1457-1463)."""
    return jnp.max(px, axis=-1)


def _quality(grey, optimum: float, kind: str):
    """Triangular quality, boosted for long exposures by /optimum^2;
    the brightest facet rules the shadows (kind 'low'), the darkest the
    highlights (kind 'high') (envutil_payload.cc:1390-1445)."""
    grey_is_large = grey > optimum
    distance = jnp.abs(optimum - grey)
    if kind == "low":
        distance = jnp.where(grey_is_large, distance, 0.0)
    elif kind == "high":
        distance = jnp.where(grey_is_large, 0.0, distance)
    return (optimum - distance) / (optimum * optimum)


def hdr_merge_stack(px_list, brightens, nch: int):
    """Exposure fusion from precomputed per-facet pixels (each
    (..., C)) and their brighten factors."""
    has_alpha = nch in (2, 4)
    lo_i = int(np.argmin(brightens))
    hi_i = int(np.argmax(brightens))

    acc = None
    qsum = None
    alpha_max = None
    for i, px in enumerate(px_list):
        kind = "low" if i == lo_i else ("high" if i == hi_i else "mid")
        optimum = 0.5 * brightens[i]
        if has_alpha:
            alpha = px[..., -1]
            grey = _grey_project(px[..., :nch - 1])
            q = alpha * _quality(grey, optimum, kind)
            safe_a = jnp.where(alpha > 1e-6, alpha, 1.0)
            colour = jnp.where((alpha > 1e-6)[..., None],
                               px[..., :nch - 1] / safe_a[..., None], 0.0)
            contrib = colour * q[..., None]
            alpha_max = alpha if alpha_max is None else \
                jnp.maximum(alpha_max, alpha)
        else:
            grey = _grey_project(px)
            q = _quality(grey, optimum, kind)
            contrib = px * q[..., None]
        acc = contrib if acc is None else acc + contrib
        qsum = q if qsum is None else qsum + q

    good = (qsum > 0.0)[..., None]
    colour = jnp.where(good, acc / jnp.where(good, qsum[..., None], 1.0),
                       0.0)
    if has_alpha:
        colour = colour * alpha_max[..., None]
        return jnp.concatenate([colour, alpha_max[..., None]], -1)
    return colour


def hdr_merge(sources, rays, nch: int):
    px_list = [E.lookup(src, ray, nch)[0]
               for src, ray in zip(sources, rays)]
    brightens = [s.static.brighten for s in sources]
    return hdr_merge_stack(px_list, brightens, nch)


SYNOPSES = {
    "voronoi": voronoi,
    "voronoi_plus": voronoi_plus,
    "hdr_merge": hdr_merge,
}


def pick_synopsis(name: str, nch: int):
    """panorama -> voronoi (opaque) or voronoi_plus (alpha), matching
    roll_out (envutil_payload.cc:2298-2320)."""
    if name == "hdr_merge":
        return hdr_merge
    if name == "panorama":
        return voronoi if nch in (1, 3) else voronoi_plus
    raise ValueError(f"unknown synopsis {name!r}")


def _tangential_basis(p0, p10, p01):
    """--twine_precise derivative basis (twining.h:152-263): instead
    of plain differencing, draw a line through the neighbour ray
    point with the pickup ray as direction and take its closest point
    to the pickup - the orthogonal projection of the neighbour onto
    the pickup's tangent plane (for unit pickup rays). The reference
    assigns Imath::Line3's ``dir`` member the UNNORMALIZED pickup ray
    and uses closestPointTo's ``pos + dir * ((q - pos) . dir)``
    verbatim, so we replicate exactly that formula (rays from the
    steppers are normalized, making it the textbook projection; any
    non-unit scale reproduces the reference bit for bit)."""
    def proj(pn):
        # t = (p0 - pn) . p0 ;  d = pn + t * p0 - p0
        t = sum((a - b) * a for a, b in zip(p0, pn))
        return tuple(b + t * a - a for a, b in zip(p0, pn))
    return proj(p10), proj(p01)


def twined(syn, sources, ninepacks, nch: int, spread,
           bias: float = 1.0 / DERIV_BIAS, precise: bool = False):
    """Apply a synopsis through a twining spread: ninepacks are
    (p0, p10, p01) ray triples per facet; each spread coefficient
    (cx, cy, w) deflects every facet's rays by cx*du + cy*dv (du, dv
    differenced and implicitly scaled back up by `bias` = 1/0.25,
    envutil_payload.cc:611-691). ``precise`` selects the
    tangent-plane derivative basis (--twine_precise,
    environment.h:1997 -> twining.h deriv_tangential)."""
    derivs = []
    for p0, p10, p01 in ninepacks:
        if precise:
            du, dv = _tangential_basis(p0, p10, p01)
        else:
            du = tuple(a - b for a, b in zip(p10, p0))
            dv = tuple(a - b for a, b in zip(p01, p0))
        derivs.append((p0, du, dv))

    out = None
    for (cx, cy, w) in spread:
        cx = float(cx) * bias
        cy = float(cy) * bias
        rays = [tuple(p + cx * u + cy * v
                      for p, u, v in zip(p0, du, dv))
                for (p0, du, dv) in derivs]
        px = syn(sources, rays, nch)
        term = float(w) * px
        out = term if out is None else out + term
    return out
