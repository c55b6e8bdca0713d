"""Projection math: 2D planar coordinates <-> 3D rays, cube-face logic.

This is the equivalent of the reference's geometry.h
(ll_to_ray_t geometry.h:152, ray_to_ll_t:277, rect:328/363, cyl:389/417,
ster:445/481, fish:513/539, ir_to_ray_t:663, ba6_to_ray_t:860,
ray_to_cubeface:1178, ray_to_cubeface_fixed:1376, ray_to_ir_t:1460,
ray_to_ba6_t:1532).

Design notes:

* All functions are pure jax-traceable math in *structure-of-arrays*
  form: a planar coordinate is a pair of arrays ``(px, py)``, a ray is a
  triple ``(x, y, z)``, each component an arbitrary-shape array. Keeping
  components as separate planes keeps a size-2/3 trailing axis out of
  the elementwise layout XLA fuses.
* Branching over cube faces and projections is branchless masked select
  (``jnp.where``) - the vector analogue of the reference's SIMD masks.
* Everything is dtype-polymorphic: feed float32 for the device pipeline
  or float64 (with jax_enable_x64) for the property tests, which mirror
  the reference's geometry.cc round-trip tests at 1e-13.

Axis convention: x=RIGHT, y=DOWN, z=FORWARD (see conventions.py).
"""

from __future__ import annotations

import math
from functools import partial

import jax.numpy as jnp

from .conventions import Face, Projection

# type aliases for documentation purposes only
Ray = tuple  # (x, y, z) arrays
Planar = tuple  # (px, py) arrays


# ---------------------------------------------------------------------------
# spherical (lat/lon)
# ---------------------------------------------------------------------------

def ll_to_ray(lon, lat) -> Ray:
    """lon/lat (radians) -> unit ray. Reference: geometry.h:152-261.

    lon 0 / lat 0 is straight ahead (0,0,1); lon grows to the right,
    lat grows downwards."""
    sinlat = jnp.sin(lat)
    coslat = jnp.cos(lat)
    sinlon = jnp.sin(lon)
    coslon = jnp.cos(lon)
    return (sinlon * coslat, sinlat, coslon * coslat)


def ray_to_ll(x, y, z) -> Planar:
    """ray -> lon/lat; accepts unnormalized rays. Reference: geometry.h:277-301."""
    s = jnp.sqrt(x * x + z * z)
    lat = jnp.arctan2(y, s)
    lon = jnp.arctan2(x, z)
    return (lon, lat)


# ---------------------------------------------------------------------------
# rectilinear
# ---------------------------------------------------------------------------

def rect_to_ray(px, py) -> Ray:
    """planar (on plane at unit forward distance) -> ray (not normalized).
    Reference: geometry.h:362-386."""
    return (px, py, jnp.ones_like(px))


def ray_to_rect(x, y, z) -> Planar:
    """ray -> planar by division by z. z==0 yields inf, back-hemisphere
    rays produce output (mirroring reference behavior, geometry.h:327-356)."""
    return (x / z, y / z)


# ---------------------------------------------------------------------------
# cylindrical
# ---------------------------------------------------------------------------

def cyl_to_ray(px, py) -> Ray:
    """planar (x = azimuth in radians, y = height on unit cylinder) -> ray
    (not normalized). Reference: geometry.h:416-442."""
    return (jnp.sin(px), py, jnp.cos(px))


def ray_to_cyl(x, y, z) -> Planar:
    """Reference: geometry.h:388-412."""
    s = jnp.sqrt(x * x + z * z)
    return (jnp.arctan2(x, z), y / s)


# ---------------------------------------------------------------------------
# stereographic
# ---------------------------------------------------------------------------

def ster_to_ray(px, py) -> Ray:
    """Reference: geometry.h:480-510."""
    r = jnp.sqrt(px * px + py * py)
    theta = 2.0 * jnp.arctan(r * 0.5)
    phi = jnp.arctan2(px, -py)
    sin_t = jnp.sin(theta)
    return (sin_t * jnp.sin(phi), -sin_t * jnp.cos(phi), jnp.cos(theta))


def ray_to_ster(x, y, z) -> Planar:
    """Reference: geometry.h:444-476. Normalizes, then projects from the
    point opposite the view center; z == -1 produces huge values."""
    rn = 1.0 / jnp.sqrt(x * x + y * y + z * z)
    factor = 2.0 / (z * rn + 1.0)
    return (x * rn * factor, y * rn * factor)


# ---------------------------------------------------------------------------
# fisheye
# ---------------------------------------------------------------------------

def fish_to_ray(px, py) -> Ray:
    """Reference: geometry.h:538-567."""
    r = jnp.sqrt(px * px + py * py)
    phi = jnp.arctan2(px, -py)
    sin_r = jnp.sin(r)
    return (sin_r * jnp.sin(phi), -sin_r * jnp.cos(phi), jnp.cos(r))


def ray_to_fish(x, y, z) -> Planar:
    """Reference: geometry.h:512-534."""
    s = jnp.sqrt(x * x + y * y)
    r = (0.5 * math.pi) - jnp.arctan2(z, s)
    phi = jnp.arctan2(y, x)
    return (r * jnp.cos(phi), r * jnp.sin(phi))


# ---------------------------------------------------------------------------
# cube faces
# ---------------------------------------------------------------------------

def ray_to_cubeface(x, y, z):
    """Dominant-axis cube face selection + in-face coordinates.

    Returns (face, fx, fy) with face an int32 array in [0,5] (Face enum)
    and in-face coordinates in (-1,1) on the plane draped at unit
    distance. Branchless version of the reference's masked-SIMD cascade
    (geometry.h:1178-1289).
    """
    ax, ay, az = jnp.abs(x), jnp.abs(y), jnp.abs(z)
    m1 = ax >= ay
    m2 = ax >= az
    m3 = ay >= az

    dom_x = m1 & m2
    dom_z = (~m2) & (~m3)
    # remaining lanes have dominant y: dom_y = (~m1) & m3

    face = jnp.where(
        dom_x,
        jnp.where(x < 0, int(Face.LEFT), int(Face.RIGHT)),
        jnp.where(
            dom_z,
            jnp.where(z < 0, int(Face.BACK), int(Face.FRONT)),
            jnp.where(y < 0, int(Face.TOP), int(Face.BOTTOM)),
        ),
    ).astype(jnp.int32)

    # guard the inactive divisions against 0/0 (where() evaluates both
    # sides; inf is fine but nan would poison the select on some paths)
    safe = lambda d: jnp.where(d == 0, jnp.ones_like(d), d)

    fx = jnp.where(
        dom_x,
        -z / safe(x),
        jnp.where(dom_z, x / safe(z), -x / safe(ay)),
    )
    fy = jnp.where(
        dom_x,
        y / safe(ax),
        jnp.where(dom_z, y / safe(az), z / safe(y)),
    )
    return face, fx, fy


def ray_to_cubeface_fixed(x, y, z, face):
    """In-plane coordinates for a *given* face (used to keep derivative
    rays on the same face during twining). Reference: geometry.h:1376-1444."""
    dom = face >> 1
    ax, ay, az = jnp.abs(x), jnp.abs(y), jnp.abs(z)
    safe = lambda d: jnp.where(d == 0, jnp.ones_like(d), d)
    fx = jnp.where(
        dom == 0,
        -z / safe(x),
        jnp.where(dom == 1, -x / safe(ay), x / safe(z)),
    )
    fy = jnp.where(
        dom == 0,
        y / safe(ax),
        jnp.where(dom == 1, z / safe(y), y / safe(az)),
    )
    return fx, fy


def in_face_to_ray(face, fx, fy):
    """Per-face in-face planar -> ray, all faces branchless.

    Mirrors the case switch in ir_to_ray_t (geometry.h:722-772 and
    in_face_to_ray geometry.h:577-637, openEXR top/bottom orientation)."""
    one = jnp.ones_like(fx)
    dom = face >> 1
    neg = (face & 1) == 0  # LEFT / TOP / FRONT... careful: sign below

    # dominant x: RIGHT (+1) / LEFT (-1)
    is_right = face == int(Face.RIGHT)
    is_bottom = face == int(Face.BOTTOM)
    is_front = face == int(Face.FRONT)

    x_dx = jnp.where(is_right, one, -one)
    y_dx = fy
    z_dx = jnp.where(is_right, -fx, fx)

    x_dy = -fx
    y_dy = jnp.where(is_bottom, one, -one)
    z_dy = jnp.where(is_bottom, fy, -fy)

    x_dz = jnp.where(is_front, fx, -fx)
    y_dz = fy
    z_dz = jnp.where(is_front, one, -one)

    x = jnp.where(dom == 0, x_dx, jnp.where(dom == 1, x_dy, x_dz))
    y = jnp.where(dom == 0, y_dx, jnp.where(dom == 1, y_dy, y_dz))
    z = jnp.where(dom == 0, z_dx, jnp.where(dom == 1, z_dy, z_dz))
    return (x, y, z)


# ---------------------------------------------------------------------------
# cubemap IR image (1:6 stripe) <-> ray
# ---------------------------------------------------------------------------

def ir_to_ray(px, py, section_md=2.0, refc_md=1.0, centered=True) -> Ray:
    """2D IR-image model-space coordinate -> ray.

    ``section_md`` is the width of one section in model-space units,
    ``refc_md`` the distance from a section's left/top edge to the cube
    face center. Reference: ir_to_ray_t, geometry.h:663-852."""
    if centered:
        px = px + refc_md
        py = py + 3.0 * section_md
    # truncation toward zero matches the C++ int() conversion
    section = jnp.trunc(py / section_md).astype(jnp.int32)
    fy = py - section.astype(py.dtype) * section_md - refc_md
    fx = px - refc_md
    return in_face_to_ray(section, fx, fy)


def ba6_to_ray(px, py, section_md=2.0, refc_md=1.0, centered=True) -> Ray:
    """Like ir_to_ray with the biatan6 in-plane transform
    tan(c * pi/4) applied to the in-face coordinate.
    Reference: ba6_to_ray_t, geometry.h:860-1056."""
    if centered:
        px = px + refc_md
        py = py + 3.0 * section_md
    section = jnp.trunc(py / section_md).astype(jnp.int32)
    fy = py - section.astype(py.dtype) * section_md - refc_md
    fx = px - refc_md
    fx = jnp.tan(fx * (math.pi / 4.0))
    fy = jnp.tan(fy * (math.pi / 4.0))
    return in_face_to_ray(section, fx, fy)


def ray_to_ir(x, y, z, section_md=2.0, refc_md=1.0, centered=True) -> Planar:
    """ray -> 2D IR model-space coordinate. Reference: ray_to_ir_t,
    geometry.h:1460-1528."""
    face, fx, fy = ray_to_cubeface(x, y, z)
    px = fx + refc_md
    py = fy + refc_md + face.astype(fx.dtype) * section_md
    if centered:
        px = px - refc_md
        py = py - 3.0 * section_md
    return (px, py)


def ray_to_ba6(x, y, z, section_md=2.0, refc_md=1.0, centered=True) -> Planar:
    """Reference: ray_to_ba6_t, geometry.h:1532-1608."""
    face, fx, fy = ray_to_cubeface(x, y, z)
    fx = (4.0 / math.pi) * jnp.arctan(fx)
    fy = (4.0 / math.pi) * jnp.arctan(fy)
    px = fx + refc_md
    py = fy + refc_md + face.astype(fx.dtype) * section_md
    if centered:
        px = px - refc_md
        py = py - 3.0 * section_md
    return (px, py)


# ---------------------------------------------------------------------------
# runtime dispatch (the analogue of roll_out_23 / roll_out_32,
# geometry.h:1764-1834) - resolved at trace time, so it's free.
# ---------------------------------------------------------------------------

def to_ray(projection: Projection, section_md=2.0, refc_md=1.0):
    """Return the planar->ray function for ``projection``."""
    projection = Projection(projection)
    if projection == Projection.SPHERICAL:
        return ll_to_ray
    if projection == Projection.CYLINDRICAL:
        return cyl_to_ray
    if projection == Projection.RECTILINEAR:
        return rect_to_ray
    if projection == Projection.STEREOGRAPHIC:
        return ster_to_ray
    if projection == Projection.FISHEYE:
        return fish_to_ray
    if projection == Projection.CUBEMAP:
        return partial(ir_to_ray, section_md=section_md, refc_md=refc_md)
    if projection == Projection.BIATAN6:
        return partial(ba6_to_ray, section_md=section_md, refc_md=refc_md)
    raise ValueError(f"unhandled projection {projection}")


def to_plane(projection: Projection, section_md=2.0, refc_md=1.0):
    """Return the ray->planar function for ``projection``."""
    projection = Projection(projection)
    if projection == Projection.SPHERICAL:
        return ray_to_ll
    if projection == Projection.CYLINDRICAL:
        return ray_to_cyl
    if projection == Projection.RECTILINEAR:
        return ray_to_rect
    if projection == Projection.STEREOGRAPHIC:
        return ray_to_ster
    if projection == Projection.FISHEYE:
        return ray_to_fish
    if projection == Projection.CUBEMAP:
        return partial(ray_to_ir, section_md=section_md, refc_md=refc_md)
    if projection == Projection.BIATAN6:
        return partial(ray_to_ba6, section_md=section_md, refc_md=refc_md)
    raise ValueError(f"unhandled projection {projection}")


# ---------------------------------------------------------------------------
# small vector helpers
# ---------------------------------------------------------------------------

def normalize(x, y, z) -> Ray:
    n = jnp.sqrt(x * x + y * y + z * z)
    return (x / n, y / n, z / n)


def apply_matrix(m, x, y, z) -> Ray:
    """Apply a static 3x3 rotation matrix (host-side numpy / nested list)
    to a SoA ray: out = m @ [x, y, z]. The matrix entries are baked into
    the jaxpr as constants."""
    return (
        m[0][0] * x + m[0][1] * y + m[0][2] * z,
        m[1][0] * x + m[1][1] * y + m[1][2] * z,
        m[2][0] * x + m[2][1] * y + m[2][2] * z,
    )
