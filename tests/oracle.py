"""Independent float64 oracle renderer for golden verification.

This module re-implements the reference pipeline (kfjahnke/envutil)
directly from the reference sources in deliberately naive numpy
float64, WITHOUT importing anything from envutil. It exists to
make the >= 50 dB PSNR north star falsifiable: envutil and this
oracle share no code paths, so a systematic error (e.g. a half-pixel
convention slip) in either one shows up as a PSNR drop.

Every function cites the reference formula it implements. Design
choices that differ from envutil on purpose:
  * prefilter = direct dense solve of the b-spline collocation system
    (the interpolating spline per BC is unique, so this matches the
    reference's recursive IIR filter exactly in exact arithmetic;
    envutil uses a truncated FIR inverse instead)
  * evaluation = per-pixel gather with python-built index maps
    (envutil uses fused kernels / XLA)
  * rotations from explicit axis matrices (envutil builds them
    from a closed-form Euler expression)

Scope: the five BASELINE.json configs (mount sources incl. full
sphericals, cubemap/biatan6 IR sources, all seven target projections,
voronoi + hdr_merge synopsis, twining, lens correction polynomial).
"""

from __future__ import annotations

import math

import numpy as np

RIGHT, DOWN, FORWARD = 0, 1, 2

# face order (envutil_basic.h:56-63)
CM_LEFT, CM_RIGHT, CM_TOP, CM_BOTTOM, CM_FRONT, CM_BACK = range(6)

SPHERICAL = "spherical"
CYLINDRICAL = "cylindrical"
RECTILINEAR = "rectilinear"
STEREOGRAPHIC = "stereographic"
FISHEYE = "fisheye"
CUBEMAP = "cubemap"
BIATAN6 = "biatan6"


# ---------------------------------------------------------------- rotation

def _rx(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)


def _ry(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def _rz(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)


def rotation(roll, pitch, yaw, inverse=False):
    """Imath Eulerf(roll, pitch, yaw, ZXY).toQuat() as a column-acting
    matrix (envutil_payload.cc:136-205 rotate_3d): applying the
    reference's rotate(v, make_r3_t(r,p,y,false)) equals R @ v with
    R = Ry(yaw) Rx(pitch) Rz(roll) (verified against Imath truth
    data in tests/data/imath_rotation_truth.json)."""
    m = _ry(yaw) @ _rx(pitch) @ _rz(roll)
    return m.T if inverse else m


# ------------------------------------------------------- extent / metrics

def get_vfov(projection, width, height, hfov):
    """envutil_basic.cc:50-97."""
    if projection == RECTILINEAR:
        return 2.0 * math.atan(height * math.tan(hfov / 2.0) / width)
    if projection == CYLINDRICAL:
        return 2.0 * math.atan(height / (width / hfov) / 2.0)
    if projection == STEREOGRAPHIC:
        w_rad = 2.0 * math.tan(hfov / 4.0)
        return 4.0 * math.atan(height / (width / w_rad) / 2.0)
    if projection in (SPHERICAL, FISHEYE):
        return hfov * height / width
    if projection in (CUBEMAP, BIATAN6):
        return 2.0 * math.pi
    return hfov


def get_step(projection, width, height, hfov):
    """envutil_basic.cc:112-145."""
    if projection in (RECTILINEAR, CUBEMAP):
        return math.atan(2.0 * math.tan(hfov / 2.0) / width)
    if projection in (BIATAN6, SPHERICAL, CYLINDRICAL, FISHEYE):
        return hfov / width
    if projection == STEREOGRAPHIC:
        return math.atan(4.0 * math.tan(hfov / 4.0) / width)
    return 0.0


def get_extent(projection, width, height, hfov):
    """envutil_basic.cc:158-226. Returns (x0, x1, y0, y1)."""
    ax, bx = -hfov / 2.0, hfov / 2.0
    by = get_vfov(projection, width, height, hfov) / 2.0
    ay = -by
    if projection in (SPHERICAL, FISHEYE):
        return ax, bx, ay, by
    if projection == CYLINDRICAL:
        return ax, bx, math.tan(ay), math.tan(by)
    if projection == RECTILINEAR:
        return math.tan(ax), math.tan(bx), math.tan(ay), math.tan(by)
    if projection == STEREOGRAPHIC:
        return (2 * math.tan(ax / 2), 2 * math.tan(bx / 2),
                2 * math.tan(ay / 2), 2 * math.tan(by / 2))
    if projection in (CUBEMAP, BIATAN6):
        x0, x1 = math.tan(ax), math.tan(bx)
        return x0, x1, 6 * x0, 6 * x1
    raise ValueError(projection)


# -------------------------------------------------------- 2D <-> 3D rays

def to_ray(projection, px, py):
    """planar -> 3D ray, geometry.h:152-1608 (NOT normalized)."""
    out = np.empty(px.shape + (3,), np.float64)
    if projection == SPHERICAL:
        # ll_to_ray_t (geometry.h:152)
        lon, lat = px, py
        out[..., RIGHT] = np.sin(lon) * np.cos(lat)
        out[..., DOWN] = np.sin(lat)
        out[..., FORWARD] = np.cos(lon) * np.cos(lat)
    elif projection == CYLINDRICAL:
        # cyl_to_ray_t (geometry.h:417)
        out[..., RIGHT] = np.sin(px)
        out[..., DOWN] = py
        out[..., FORWARD] = np.cos(px)
    elif projection == RECTILINEAR:
        # rect_to_ray_t (geometry.h:363)
        out[..., RIGHT] = px
        out[..., DOWN] = py
        out[..., FORWARD] = 1.0
    elif projection == STEREOGRAPHIC:
        # ster_to_ray_t (geometry.h:481)
        r = np.sqrt(px * px + py * py)
        theta = 2.0 * np.arctan(r / 2.0)
        phi = np.arctan2(px, -py)
        out[..., FORWARD] = np.cos(theta)
        out[..., DOWN] = -np.sin(theta) * np.cos(phi)
        out[..., RIGHT] = np.sin(theta) * np.sin(phi)
    elif projection == FISHEYE:
        # fish_to_ray_t (geometry.h:539)
        r = np.sqrt(px * px + py * py)
        phi = np.arctan2(px, -py)
        out[..., FORWARD] = np.cos(r)
        out[..., DOWN] = -np.sin(r) * np.cos(phi)
        out[..., RIGHT] = np.sin(r) * np.sin(phi)
    else:
        raise ValueError(projection)
    return out


def from_ray(projection, ray):
    """3D ray -> planar, geometry.h:277-567. Returns (px, py)."""
    r, d, f = ray[..., RIGHT], ray[..., DOWN], ray[..., FORWARD]
    if projection == SPHERICAL:
        # ray_to_ll_t (geometry.h:277)
        s = np.sqrt(r * r + f * f)
        return np.arctan2(r, f), np.arctan2(d, s)
    if projection == CYLINDRICAL:
        # ray_to_cyl_t (geometry.h:389)
        s = np.sqrt(r * r + f * f)
        return np.arctan2(r, f), d / s
    if projection == RECTILINEAR:
        # ray_to_rect_t (geometry.h:328)
        with np.errstate(divide="ignore", invalid="ignore"):
            return r / f, d / f
    if projection == STEREOGRAPHIC:
        # ray_to_ster_t (geometry.h:445)
        rn = 1.0 / np.sqrt(r * r + d * d + f * f)
        factor = 2.0 / (f * rn + 1.0)
        return r * rn * factor, d * rn * factor
    if projection == FISHEYE:
        # ray_to_fish_t (geometry.h:513)
        s = np.sqrt(r * r + d * d)
        rr = math.pi / 2 - np.arctan2(f, s)
        phi = np.arctan2(d, r)
        return rr * np.cos(phi), rr * np.sin(phi)
    raise ValueError(projection)


def ray_to_cubeface(ray):
    """geometry.h:1178-1357: dominant-axis face pick + in-face coords.
    Returns (face, ifx, ify)."""
    c0, c1, c2 = ray[..., RIGHT], ray[..., DOWN], ray[..., FORWARD]
    a0, a1, a2 = np.abs(c0), np.abs(c1), np.abs(c2)
    m1 = a0 >= a1
    m2 = a0 >= a2
    m3 = a1 >= a2
    face = np.empty(c0.shape, np.int64)
    ifx = np.empty(c0.shape, np.float64)
    ify = np.empty(c0.shape, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        dom = m1 & m2   # right axis dominant
        face[dom] = np.where(c0[dom] < 0, CM_LEFT, CM_RIGHT)
        ifx[dom] = (-c2 / c0)[dom]
        ify[dom] = (c1 / a0)[dom]
        dom = (~m2) & (~m3)   # forward dominant
        face[dom] = np.where(c2[dom] < 0, CM_BACK, CM_FRONT)
        ifx[dom] = (c0 / c2)[dom]
        ify[dom] = (c1 / a2)[dom]
        dom = (~m1) & m3      # down dominant
        face[dom] = np.where(c1[dom] < 0, CM_TOP, CM_BOTTOM)
        ifx[dom] = (-c0 / a1)[dom]
        ify[dom] = (c2 / c1)[dom]
    return face, ifx, ify


def cubeface_ray(face, p0, p1):
    """in-face planar (+1 forward) -> ray per face, following the
    cubemap_stepper case switch (stepper.h:1303-1334) in identity
    basis: ray = ccc + p0 * vvv."""
    one = np.ones_like(p0)
    out = np.empty(p0.shape + (3,), np.float64)
    sel = [
        # face: (right, down, forward)
        (CM_LEFT, (-one, p1, p0)),
        (CM_RIGHT, (one, p1, -p0)),
        (CM_TOP, (-p0, -one, -p1)),
        (CM_BOTTOM, (-p0, one, p1)),
        (CM_FRONT, (p0, p1, one)),
        (CM_BACK, (-p0, p1, -one)),
    ]
    for fidx, (r, d, f) in sel:
        m = face == fidx
        out[..., RIGHT][m] = r[m]
        out[..., DOWN][m] = d[m]
        out[..., FORWARD][m] = f[m]
    return out


# --------------------------------------------------------- b-spline math

def bspline_val(degree, x):
    """Centered cardinal b-spline B_degree(x) by the Cox-de Boor
    recursion (the reference's basis_functor, zimt/basis.h:411)."""
    x = np.asarray(x, np.float64)
    if degree == 0:
        return ((x >= -0.5) & (x < 0.5)).astype(np.float64)
    n = degree
    return ((x + (n + 1) / 2.0) * bspline_val(n - 1, x + 0.5)
            + ((n + 1) / 2.0 - x) * bspline_val(n - 1, x - 0.5)) / n


def _bc_index(idx, n, bc):
    """Map out-of-range coefficient indices per zimt brace semantics
    (zimt/common.h:83-86, zimt/bspline.h:311-438). Returns (mapped
    index array, sign array, dc array) implementing
    c[idx] = sign * c[mapped] + dc * c[0 or n-1]-style extension;
    NATURAL needs the affine form c[-k] = 2c[0] - c[k]."""
    idx = np.asarray(idx)
    if bc == "periodic":
        return idx % n, None
    if bc == "mirror":
        # f(-x) == f(x): period 2n-2, reflect at 0 and n-1
        if n == 1:
            return np.zeros_like(idx), None
        p = idx % (2 * n - 2)
        return np.where(p > n - 1, 2 * n - 2 - p, p), None
    if bc == "reflect":
        # f(-1) == f(0): period 2n, reflect between samples
        p = idx % (2 * n)
        return np.where(p > n - 1, 2 * n - 1 - p, p), None
    if bc == "natural":
        # f(-x) + f(x) == 2 f(0): affine extension
        return None, idx
    raise ValueError(bc)


def prefilter_periodic_fft(data, degree):
    """prefilter_1d for the periodic boundary condition. The
    collocation matrix is then circulant, so the same unique solution
    comes from one division in Fourier space: O(n log n) where the
    dense solve is O(n^3), which makes full 8K and 16K sources
    checkable."""
    n = data.shape[0]
    half = degree // 2
    taps = np.arange(-half, half + 1)
    w = bspline_val(degree, taps.astype(np.float64))
    k = np.arange(n // 2 + 1)
    # the circulant's eigenvalues: sum_t w_t exp(2 pi i k t / n), real
    # because the B-spline taps are symmetric
    lam = sum(wt * np.cos(2.0 * math.pi * k * t / n)
              for t, wt in zip(taps, w))
    flat = np.asarray(data, np.float64).reshape(n, -1)
    out = np.fft.irfft(np.fft.rfft(flat, axis=0) / lam[:, None], n,
                       axis=0)
    return out.reshape(data.shape)


def prefilter_1d(data, degree, bc):
    """Solve the collocation system sum_k c_k B(i - k) = data_i along
    axis 0 with the BC-implied coefficient extension. The solution is
    the unique interpolating spline, matching the reference's
    recursive prefilter (zimt/prefilter.h:133) exactly. Long periodic
    signals are solved in Fourier space (prefilter_periodic_fft)."""
    if degree < 2:
        return np.array(data, np.float64)
    n = data.shape[0]
    if bc == "periodic" and n > 2048:
        return prefilter_periodic_fft(data, degree)
    half = degree // 2
    taps = np.arange(-half, half + 1)
    w = bspline_val(degree, taps.astype(np.float64))
    a = np.zeros((n, n), np.float64)
    for i in range(n):
        for t, wt in zip(taps, w):
            j = i + t
            if 0 <= j < n:
                a[i, j] += wt
            elif bc == "periodic":
                a[i, j % n] += wt
            elif bc == "mirror":
                p = j % (2 * n - 2) if n > 1 else 0
                a[i, 2 * n - 2 - p if p > n - 1 else p] += wt
            elif bc == "reflect":
                p = j % (2 * n)
                a[i, 2 * n - 1 - p if p > n - 1 else p] += wt
            elif bc == "natural":
                # c[-k] = 2c[0] - c[k]; c[n-1+k] = 2c[n-1] - c[n-1-k]
                if j < 0:
                    a[i, 0] += 2 * wt
                    a[i, -j] -= wt
                else:
                    a[i, n - 1] += 2 * wt
                    a[i, 2 * (n - 1) - j] -= wt
            else:
                raise ValueError(bc)
    flat = np.asarray(data, np.float64).reshape(n, -1)
    return np.linalg.solve(a, flat).reshape(data.shape)


def spherical_prefilter(img, degree):
    """Full-spherical prefilter: horizontal PERIODIC pass, vertical
    PERIODIC pass over the stacked left/flipped-right halves
    (environment.h:356-522)."""
    h, w, c = img.shape
    assert w % 2 == 0
    out = prefilter_1d(np.moveaxis(np.asarray(img, np.float64), 1, 0),
                       degree, "periodic")
    out = np.moveaxis(out, 0, 1)
    w2 = w // 2
    stack = np.concatenate([out[:, :w2], out[::-1, w2:]], axis=0)
    stack = prefilter_1d(stack, degree, "periodic")
    out = np.concatenate([stack[:h], stack[h:][::-1]], axis=1)
    return out


def _tap_base(s, degree):
    """First tap index per zimt eval splitting (zimt/eval.h:513+)."""
    if degree % 2:
        return np.floor(s).astype(np.int64) - (degree - 1) // 2
    return np.floor(s + 0.5).astype(np.int64) - degree // 2


class SplineField:
    """Evaluate a 2D tensor-product spline over (H, W, C) coefficients
    with per-axis BC index extension; spherical=True switches to the
    over-the-pole index map (horizontal periodic + cross-half vertical
    reflection, environment.h:465-503)."""

    def __init__(self, coeff, degree, bc_y, bc_x, spherical=False):
        self.coeff = np.asarray(coeff, np.float64)
        self.degree = degree
        self.bc_y, self.bc_x = bc_y, bc_x
        self.spherical = spherical

    def _gather(self, iy, ix):
        h, w = self.coeff.shape[:2]
        if self.spherical:
            # horizontal wrap
            ix = ix % w
            # over the poles: row -1-k maps to row k of the opposite
            # half (column + w/2), same below row h-1
            over_top = iy < 0
            over_bot = iy > h - 1
            iy = np.where(over_top, -1 - iy, iy)
            iy = np.where(over_bot, 2 * h - 1 - iy, iy)
            ix = np.where(over_top | over_bot, (ix + w // 2) % w, ix)
            return self.coeff[iy, ix]
        vy = self._axis_vals(iy, 0, self.bc_y)
        return self._mix(vy, ix, 1, self.bc_x)

    def _axis_vals(self, idx, axis, bc):
        # returns an array of coefficient rows indexed with extension
        n = self.coeff.shape[axis]
        mapped, nat = _bc_index(idx, n, bc)
        if nat is None:
            return mapped
        # natural: fold later in _mix (needs value arithmetic)
        return idx

    def _mix(self, iy, ix, axis, bc):
        # gather values c[iy, ix] honoring NATURAL's affine extension
        h, w = self.coeff.shape[:2]

        def nat_fetch(arr_idx, n):
            lo = arr_idx < 0
            hi = arr_idx > n - 1
            base = np.clip(arr_idx, 0, n - 1)
            refl = np.where(lo, -arr_idx, 2 * (n - 1) - arr_idx)
            refl = np.clip(refl, 0, n - 1)
            return base, refl, lo | hi, np.where(lo, 0, n - 1)

        if self.bc_y == "natural" or self.bc_x == "natural":
            # handle each axis' extension by value arithmetic
            vy_plain, vy_refl, vy_out, vy_edge = nat_fetch(iy, h) \
                if self.bc_y == "natural" else (None,) * 4
            if self.bc_y != "natural":
                iy2, _ = _bc_index(iy, h, self.bc_y)
            if self.bc_x != "natural":
                ix2, _ = _bc_index(ix, w, self.bc_x)
            else:
                vx_plain, vx_refl, vx_out, vx_edge = nat_fetch(ix, w)

            def fetch(iyy, ixx):
                return self.coeff[iyy, ixx]

            if self.bc_y == "natural" and self.bc_x == "natural":
                def fy(ixx):
                    v = fetch(vy_plain, ixx)
                    ref = fetch(vy_refl, ixx)
                    edge = fetch(vy_edge, ixx)
                    return np.where(vy_out[..., None],
                                    2 * edge - ref, v)
                v = fy(vx_plain)
                ref = fy(vx_refl)
                edge = fy(vx_edge)
                return np.where(vx_out[..., None], 2 * edge - ref, v)
            if self.bc_y == "natural":
                v = fetch(vy_plain, ix2)
                ref = fetch(vy_refl, ix2)
                edge = fetch(vy_edge, ix2)
                return np.where(vy_out[..., None], 2 * edge - ref, v)
            v = fetch(iy2, vx_plain)
            ref = fetch(iy2, vx_refl)
            edge = fetch(iy2, vx_edge)
            return np.where(vx_out[..., None], 2 * edge - ref, v)
        iy2, _ = _bc_index(iy, h, self.bc_y)
        ix2, _ = _bc_index(ix, w, self.bc_x)
        return self.coeff[iy2, ix2]

    def eval(self, sx, sy):
        d = self.degree
        bx = _tap_base(sx, d)
        by = _tap_base(sy, d)
        out = np.zeros(sx.shape + (self.coeff.shape[2],), np.float64)
        for jy in range(d + 1):
            wy = bspline_val(d, sy - (by + jy))
            row = np.zeros_like(out)
            for jx in range(d + 1):
                wx = bspline_val(d, sx - (bx + jx))
                row += wx[..., None] * self._gather(by + jy, bx + jx)
            out += wy[..., None] * row
        return out


# ------------------------------------------------------------ lens (PTO)

class Lens:
    """PT a,b,c radial polynomial + d,e shift + g,t shear in the
    'normal' (target->source) direction (environment.h:240-318,
    envutil_basic.h:499-543 process_geometry)."""

    def __init__(self, a=0.0, b=0.0, c=0.0, h_px=0.0, v_px=0.0,
                 shear_g=0.0, shear_t=0.0, extent=None, width=None):
        self.a, self.b, self.c = a, b, c
        x0, x1, y0, y1 = extent
        dv = abs(y1 - y0) / 2.0
        dh = abs(x1 - x0) / 2.0
        self.s = min(dh, dv)
        factor = abs(x1 - x0) / width
        self.h = h_px * factor
        self.v = v_px * factor
        self.g, self.t = shear_g, shear_t
        self.has_lcp = (a != 0 or b != 0 or c != 0)
        self.has_shift = (self.h != 0 or self.v != 0)
        self.has_shear = (shear_g != 0 or shear_t != 0)

    def apply(self, px, py):
        if self.has_lcp:
            x = np.sqrt(px * px + py * py) / self.s
            d = 1.0 - (self.a + self.b + self.c)
            factor = ((self.a * x + self.b) * x + self.c) * x + d
            px = px * factor
            py = py * factor
        if self.has_shift:
            px = px + self.h
            py = py + self.v
        if self.has_shear:
            px, py = px + py * self.g, py + px * self.t
        return px, py


# ------------------------------------------------------------- facets

class MountFacet:
    """source_t + mount_t: a non-cubemap facet (environment.h:552-1197)."""

    def __init__(self, projection, width, height, hfov, image,
                 yaw=0.0, pitch=0.0, roll=0.0, degree=3, brighten=1.0,
                 lens=None):
        self.projection = projection
        self.width, self.height, self.hfov = width, height, hfov
        self.extent = get_extent(projection, width, height, hfov)
        self.step = get_step(projection, width, height, hfov)
        self.recip_step = 1.0 / self.step
        self.brighten = brighten
        self.rot_inv = rotation(roll, pitch, yaw, inverse=True)
        self.lens = lens
        self.degree = degree
        img = np.asarray(image, np.float64)
        full_sph = (projection == SPHERICAL
                    and abs(hfov - 2 * math.pi) < 1e-6)
        bc_x = "periodic" if (projection in (SPHERICAL, CYLINDRICAL)
                              and abs(hfov - 2 * math.pi) < 1e-6) \
            else "reflect"
        if full_sph and width % 2 == 0:
            coeff = spherical_prefilter(img, degree) if degree > 1 \
                else img
            self.field = SplineField(coeff, degree, "reflect", bc_x,
                                     spherical=True)
        else:
            coeff = np.moveaxis(prefilter_1d(
                np.moveaxis(prefilter_1d(img, degree, "reflect"),
                            1, 0), degree, bc_x), 0, 1)
            self.field = SplineField(coeff, degree, "reflect", bc_x)

    def lookup(self, rays):
        """ray (facet CS) -> (pixel, mask); mount_t::eval."""
        px, py = from_ray(self.projection, rays)
        if self.lens is not None:
            px, py = self.lens.apply(px, py)
        x0, x1, y0, y1 = self.extent
        mask = (px >= x0) & (px <= x1) & (py >= y0) & (py <= y1)
        if self.projection == RECTILINEAR:
            mask &= rays[..., 2] > 0.0
        # md_to_spline (environment.h:988-1006)
        sx = (px - x0) / (x1 - x0) * self.width - 0.5
        sy = (py - y0) / (y1 - y0) * self.height - 0.5
        sx = np.where(mask, sx, 0.0)
        sy = np.where(mask, sy, 0.0)
        pix = self.field.eval(sx, sy)
        pix = np.where(mask[..., None], pix, 0.0) * self.brighten
        return pix, mask


class CubemapFacet:
    """cubemap_t IR builder + cubemap_view_t lookup (cubemap.h:517-1277,
    metrics.h:60-483, environment.h:1396-1488)."""

    def __init__(self, projection, width, hfov, image,
                 yaw=0.0, pitch=0.0, roll=0.0, degree=3, brighten=1.0,
                 support_min=8, tile_px=64):
        assert projection in (CUBEMAP, BIATAN6)
        self.projection = projection
        face_px = width
        self.step = get_step(projection, width, 6 * width, hfov)
        self.recip_step = 1.0 / self.step
        self.brighten = brighten
        self.rot_inv = rotation(roll, pitch, yaw, inverse=True)
        self.degree = degree

        # ---- metrics_t (metrics.h:209-380)
        radius_md = math.tan(hfov / 2.0) if hfov > math.pi / 2 else 1.0
        diameter_md = 2.0 * radius_md
        overscan_md = radius_md - 1.0
        self.model_to_px = face_px / diameter_md
        px_to_model = diameter_md / face_px
        px_overscan = self.model_to_px * overscan_md
        inherent = math.trunc(px_overscan)
        additional = max(0, support_min - inherent)
        px_min = face_px + 2 * additional
        n_tiles = px_min // tile_px
        if n_tiles * tile_px < px_min:
            n_tiles += 1
        s = n_tiles * tile_px
        self.section_px = s
        frame_total = s - face_px
        self.left_frame_px = frame_total // 2
        self.right_frame_px = frame_total - self.left_frame_px
        self.refc_md = px_to_model * (self.left_frame_px + face_px / 2.0)

        # ---- IR build (cubemap.h load + fill_support + prefilter)
        img = np.asarray(image, np.float64)     # (6*face_px, face_px, C)
        nch = img.shape[2]
        store = np.zeros((6 * s, s, nch), np.float64)
        lf, F = self.left_frame_px, face_px
        for f in range(6):
            store[f * s + lf:f * s + lf + F, lf:lf + F] = \
                img[f * F:(f + 1) * F]
        self._fill_support(store, face_px)
        if degree > 1:
            for f in range(6):
                sec = store[f * s:(f + 1) * s]
                sec = prefilter_1d(sec, degree, "natural")
                sec = np.moveaxis(prefilter_1d(
                    np.moveaxis(sec, 1, 0), degree, "natural"), 0, 1)
                store[f * s:(f + 1) * s] = sec
        # evaluation: pickups stay inside sections (support_min margin),
        # index extension is never hit; use mirror as a safe default
        self.field = SplineField(store, degree, "mirror", "mirror")

    def _pickup_px(self, face, ifx, ify):
        """get_pickup_coordinate_px (metrics.h:396-440): model units to
        pixel units, per-face section offset, then the -0.5 shift that
        maps margins to pixel margins (metrics.h:422-440)."""
        tx = (ifx + self.refc_md) * self.model_to_px - 0.5
        ty = (ify + self.refc_md) * self.model_to_px \
            + face * self.section_px - 0.5
        return tx, ty

    def _fill_support(self, store, face_px):
        """mirror_around + fill_support (cubemap.h:607-911): 1-px
        mirror seed, then per face re-project the frame from adjoining
        faces via bilinear pickup over the live store."""
        s = self.section_px
        lf, rf, F = self.left_frame_px, self.right_frame_px, face_px
        if lf == 0 and rf == 0:
            return
        # mirror_around: 1-px edge seed around each face core
        for f in range(6):
            sec = store[f * s:(f + 1) * s]
            c0, c1 = lf, lf + F          # core rows/cols [c0, c1)
            cmin = c0 - 1 if lf > 0 else c0
            cmax = c1 + 1 if rf > 0 else c1
            if lf > 0:
                sec[c0 - 1, cmin:cmax] = sec[c0, cmin:cmax]
                sec[cmin:cmax, c0 - 1] = sec[cmin:cmax, c0]
            if rf > 0:
                sec[c1, cmin:cmax] = sec[c1 - 1, cmin:cmax]
                sec[cmin:cmax, c1] = sec[cmin:cmax, c1 - 1]
            if lf > 0:
                # corners: mirror_around's x loop writes row -1/F over
                # x in [cmin, cmax), then the y loop writes col -1/F
                # over the same range - col writes win at corners
                sec[cmin:cmax, c0 - 1] = sec[cmin:cmax, c0]
            if rf > 0:
                sec[cmin:cmax, c1] = sec[cmin:cmax, c1 - 1]

        bil = SplineField(store, 1, "mirror", "mirror")
        ithird = self.model_to_px * 2.0
        for f in range(6):
            # frame pixel coordinates (doubled, centered):
            # crd2 = 2*i - (s-1) (cubemap.h:869-875)
            stripes = []
            if lf > 0:
                stripes.append((0, s, 0, lf))           # above
                stripes.append((0, lf, lf, s - rf))     # left
            if rf > 0:
                stripes.append((0, s, s - rf, s))       # below
                stripes.append((lf + F, s, lf, s - rf))  # right
            for x_lo, x_hi, y_lo, y_hi in stripes:
                xs = np.arange(x_lo, x_hi)
                ys = np.arange(y_lo, y_hi)
                gx, gy = np.meshgrid(xs, ys, indexing="xy")
                cx = (2 * gx - (s - 1)).astype(np.float64)
                cy = (2 * gy - (s - 1)).astype(np.float64)
                one = np.full_like(cx, ithird)
                if f == CM_FRONT:
                    ray = np.stack([cx, cy, one], -1)
                elif f == CM_BACK:
                    ray = np.stack([-cx, cy, -one], -1)
                elif f == CM_RIGHT:
                    ray = np.stack([one, cy, -cx], -1)
                elif f == CM_LEFT:
                    ray = np.stack([-one, cy, cx], -1)
                elif f == CM_BOTTOM:
                    ray = np.stack([-cx, one, cy], -1)
                else:  # CM_TOP
                    ray = np.stack([-cx, -one, -cy], -1)
                fv, ifx, ify = ray_to_cubeface(ray)
                tx, ty = self._pickup_px(fv, ifx, ify)
                # bilinear eval over the live store (deg-1 safe eval)
                store[f * s + gy.ravel() * 0 + gy,
                      gx] if False else None
                vals = bil.eval(tx, ty)
                store[f * s + gy, gx] = vals

    def lookup(self, rays):
        """cubemap_view_t: ray -> face/in-face -> (biatan6 atan) ->
        pickup -> spline eval. Full coverage: mask all true."""
        face, ifx, ify = ray_to_cubeface(rays)
        if self.projection == BIATAN6:
            ifx = (4.0 / math.pi) * np.arctan(ifx)
            ify = (4.0 / math.pi) * np.arctan(ify)
        tx, ty = self._pickup_px(face, ifx, ify)
        pix = self.field.eval(tx, ty) * self.brighten
        return pix, np.ones(rays.shape[:-1], bool)


# ------------------------------------------------------------- targets

def target_planar(projection, width, height, hfov, bias_x=0.0,
                  bias_y=0.0):
    """stepper_base edge-to-edge sampling (stepper.h:296-334)."""
    x0, x1, y0, y1 = get_extent(projection, width, height, hfov)
    i = np.arange(width, dtype=np.float64)
    j = np.arange(height, dtype=np.float64)
    bx = bias_x * (x1 - x0) / width
    by = bias_y * (y1 - y0) / height
    px = bx + x0 + (2 * i + 1) / (2 * width) * (x1 - x0)
    py = by + y0 + (2 * j + 1) / (2 * height) * (y1 - y0)
    gx, gy = np.meshgrid(px, py, indexing="xy")
    return gx, gy, (x0, x1, y0, y1)


def target_rays(projection, width, height, hfov, bias_x=0.0,
                bias_y=0.0):
    """Target pixel grid -> normalized rays in the camera CS."""
    gx, gy, extent = target_planar(projection, width, height, hfov,
                                   bias_x, bias_y)
    if projection in (CUBEMAP, BIATAN6):
        x0, x1 = extent[0], extent[1]
        section_md = x1 - x0
        refc_md = section_md / 2.0
        rows = np.arange(height) // width     # face per row
        face = np.broadcast_to(rows[:, None], gx.shape)
        p1 = gy + (3 - face) * section_md - refc_md
        p0 = gx
        if projection == BIATAN6:
            p0 = np.tan(p0 * (math.pi / 4.0))
            p1 = np.tan(p1 * (math.pi / 4.0))
        rays = cubeface_ray(face, p0, p1)
    else:
        rays = to_ray(projection, gx, gy)
    rays = rays / np.linalg.norm(rays, axis=-1, keepdims=True)
    return rays


# ------------------------------------------------------------ synopsis

def voronoi(per_facet):
    """_voronoi_syn (envutil_payload.cc:762-957): champion = facet
    maximizing z * recip_step among hits; all-miss -> 0."""
    scores = []
    for pix, mask, z, recip_step in per_facet:
        scores.append(np.where(mask, z * recip_step, -np.inf))
    scores = np.stack(scores)                 # (F, H, W)
    champ = np.argmax(scores, axis=0)
    any_hit = np.isfinite(scores).any(axis=0)
    out = np.zeros_like(per_facet[0][0])
    for i, (pix, mask, z, rs) in enumerate(per_facet):
        sel = (champ == i) & any_hit
        out[sel] = pix[sel]
    return out


def hdr_merge(per_facet, brightens):
    """_hdr_merge_syn (envutil_payload.cc:1325-1623), 3-channel path."""
    optimum = [0.5 * b for b in brightens]
    lo_idx = hi_idx = 0
    lo, hi = 1e5, -1.0
    for i, b in enumerate(brightens):
        if b < lo:
            lo, lo_idx = b, i
        if b > hi:
            hi, hi_idx = b, i
    out = np.zeros_like(per_facet[0][0])
    qsum = np.zeros(out.shape[:-1], np.float64)
    for i, (pix, mask, z, rs) in enumerate(per_facet):
        grey = np.max(pix, axis=-1)
        opt = optimum[i]
        grey_is_large = grey > opt
        distance = np.abs(opt - grey)
        if i == lo_idx:
            distance = np.where(~grey_is_large, 0.0, distance)
        elif i == hi_idx:
            distance = np.where(grey_is_large, 0.0, distance)
        quality = (opt - distance) / (opt * opt)
        qsum += quality
        out += pix * quality[..., None]
    with np.errstate(invalid="ignore"):
        out = out / qsum[..., None]
    out = np.where((qsum > 0)[..., None], out, 0.0)
    return out


# ------------------------------------------------------------- twining

def make_spread(w=2, h=0, d=1.0, sigma=0.0, threshold=0.0):
    """envutil_main.cc:1253-1355."""
    if w <= 2:
        w = 2
    if h <= 0:
        h = w
    wgt = 1.0 / (w * h)
    x0 = -(w - 1.0) / (2.0 * w)
    dx = 1.0 / w
    y0 = -(h - 1.0) / (2.0 * h)
    dy = 1.0 / h
    trg = []
    sigma = sigma * -x0
    total = 0.0
    for y in range(h):
        for x in range(w):
            wf = 1.0
            if sigma > 0.0:
                wx = (x0 + x * dx) / sigma
                wy = (y0 + y * dy) / sigma
                wf = math.exp(-math.sqrt(wx * wx + wy * wy))
            v = [np.float32(d * (x0 + x * dx)),
                 np.float32(d * (y0 + y * dy)),
                 np.float32(wf * wgt)]
            trg.append(v)
            total += wf * wgt
    if sigma != 0.0:
        th_sum = 0.0
        renorm = False
        for v in trg:
            v[2] = np.float32(v[2] / total)
            if v[2] >= threshold:
                th_sum += v[2]
            else:
                renorm = True
                v[2] = 0.0
        if renorm:
            for v in trg:
                v[2] = np.float32(v[2] / th_sum)
            trg = [v for v in trg if v[2] > 0.0]
    return [(float(a), float(b), float(c)) for a, b, c in trg]


def auto_twine(mag, spline_degree, nfacets, twine_max=8):
    """twine_setup's automatic parameterization
    (envutil_main.cc:1405-1616). Returns (twine, twine_width)."""
    if mag > 1.0:
        if spline_degree > 1:
            if nfacets > 1:
                return 3, 1.0
            if mag < 2.0:
                return 2, 1.0
            return 1, 1.0
        return min(5, int(1.0 + mag)), mag
    return min(twine_max, int(1.0 + 1.0 / mag)), 1.0


# ------------------------------------------------------------- renderer

def render(target, facets, synopsis="panorama", spread=None,
           twine_precise=False, pixels=None):
    """Full oracle pipeline. ``target`` is a dict with projection,
    width, height, hfov, yaw, pitch, roll; ``facets`` a list of
    MountFacet/CubemapFacet; ``spread`` a list of (x, y, w) twining
    coefficients or None; ``pixels`` an optional (rows, cols) pair of
    index arrays: only those target pixels are rendered, and the result
    is (N, C) instead of (H, W, C).

    Mirrors fuse() (envutil_payload.cc:1885-2290): per facet,
    facet_ray = R_facet^-1 @ R_camera @ target_ray; twining via
    synopsis_t (deflect all facets' rays per tap, weight-sum,
    envutil_payload.cc:587-691) with deriv_stepper bias 0.25 and
    twine_t bias factor 4.0."""
    prj = target["projection"]
    w, h = target["width"], target["height"]
    hfov = target["hfov"]
    r_cam = rotation(target.get("roll", 0.0), target.get("pitch", 0.0),
                     target.get("yaw", 0.0))

    def facet_rays(bias_x=0.0, bias_y=0.0):
        rays = target_rays(prj, w, h, hfov, bias_x, bias_y)
        if pixels is not None:
            rays = rays[pixels]
        out = []
        for fct in facets:
            m = fct.rot_inv @ r_cam
            out.append(rays @ m.T)
        return out

    center = facet_rays()

    def synth(rays_per_facet):
        per = []
        for fct, rays in zip(facets, rays_per_facet):
            pix, mask = fct.lookup(rays)
            per.append((pix, mask, rays[..., 2], fct.recip_step))
        if synopsis == "hdr_merge":
            return hdr_merge(per, [f.brighten for f in facets])
        return voronoi(per)

    if not spread:
        return synth(center)

    # ninepacks: sub-rays at planar bias 0.25 in x and y
    r10 = facet_rays(bias_x=0.25)
    r01 = facet_rays(bias_y=0.25)
    out = None
    for cx, cy, cw in spread:
        deflected = []
        for c, p10, p01 in zip(center, r10, r01):
            if twine_precise:
                # deriv_tangential (twining.h:152-263): closest point
                # to the pickup on the line through the neighbour with
                # direction 'pickup', minus the pickup - Imath
                # Line3::closestPointTo with the UNNORMALIZED pickup
                # ray as dir, exactly as the reference assigns it
                t10 = ((c - p10) * c).sum(-1, keepdims=True)
                t01 = ((c - p01) * c).sum(-1, keepdims=True)
                dx = p10 + t10 * c - c
                dy = p01 + t01 * c - c
            else:
                dx = p10 - c
                dy = p01 - c
            deflected.append(c + (cx * 4.0) * dx + (cy * 4.0) * dy)
        part = synth(deflected)
        out = cw * part if out is None else out + cw * part
    return out


def psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64)
                   - np.asarray(b, np.float64)) ** 2)
    return 10 * math.log10(1.0 / mse) if mse > 0 else 999.0
