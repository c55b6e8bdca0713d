"""Projection round-trip property tests.

Mirrors the verification spine of the reference's geometry.cc: for every
projection, plane->ray->plane and ray->plane->ray round trips must agree
within 1e-13 at float64 (geometry.cc:283-330, 537-982), and cube-face
selection must be consistent with the per-face inverse.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from envutil.core import geometry as geo
from envutil.core.conventions import Projection

RNG = np.random.default_rng(42)


def random_rays(n=4096, front_only=False, dtype=np.float64):
    v = RNG.normal(size=(3, n))
    v /= np.linalg.norm(v, axis=0, keepdims=True)
    if front_only:
        v[2] = np.abs(v[2]) + 0.1
        v /= np.linalg.norm(v, axis=0, keepdims=True)
    return tuple(jnp.asarray(c, dtype) for c in v)


FULL_PROJECTIONS = [Projection.SPHERICAL, Projection.FISHEYE,
                    Projection.CUBEMAP, Projection.BIATAN6]
PARTIAL_PROJECTIONS = [Projection.RECTILINEAR, Projection.CYLINDRICAL,
                       Projection.STEREOGRAPHIC]


@pytest.mark.parametrize("prj", FULL_PROJECTIONS + PARTIAL_PROJECTIONS)
def test_ray_plane_ray_roundtrip(prj):
    front = prj in (Projection.RECTILINEAR,)
    x, y, z = random_rays(front_only=front)
    if prj == Projection.CYLINDRICAL:
        # cylindrical can't represent rays near the poles well; keep
        # away from them (reference tests do the same implicitly via
        # the extent)
        keep = np.abs(np.asarray(y)) < 0.9
        x, y, z = x[keep], y[keep], z[keep]
    px, py = geo.to_plane(prj)(x, y, z)
    x2, y2, z2 = geo.to_ray(prj)(px, py)
    x2, y2, z2 = geo.normalize(x2, y2, z2)
    for a, b in zip((x, y, z), (x2, y2, z2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-12, rtol=0)


@pytest.mark.parametrize("prj", FULL_PROJECTIONS + PARTIAL_PROJECTIONS)
def test_plane_ray_plane_roundtrip(prj):
    # sample planar coordinates inside each projection's natural range
    n = 4096
    if prj == Projection.SPHERICAL:
        px = RNG.uniform(-math.pi * 0.999, math.pi * 0.999, n)
        py = RNG.uniform(-math.pi / 2 * 0.999, math.pi / 2 * 0.999, n)
    elif prj == Projection.FISHEYE:
        r = RNG.uniform(0.0, math.pi * 0.98, n)
        phi = RNG.uniform(-math.pi, math.pi, n)
        px, py = r * np.cos(phi), r * np.sin(phi)
    elif prj == Projection.CYLINDRICAL:
        px = RNG.uniform(-math.pi * 0.999, math.pi * 0.999, n)
        py = RNG.uniform(-2.0, 2.0, n)
    elif prj == Projection.RECTILINEAR:
        px = RNG.uniform(-3.0, 3.0, n)
        py = RNG.uniform(-3.0, 3.0, n)
    elif prj == Projection.STEREOGRAPHIC:
        px = RNG.uniform(-5.0, 5.0, n)
        py = RNG.uniform(-5.0, 5.0, n)
    else:  # CUBEMAP / BIATAN6: centered IR coordinates, default metrics
        px = RNG.uniform(-0.999, 0.999, n)
        py = RNG.uniform(-5.999, 5.999, n)
        # stay away from section boundaries where the face index is
        # discontinuous (the reference tests only interior points too)
        frac = np.mod(py + 6.0, 2.0)
        keep = (np.abs(frac - 1.0) < 0.98)
        px, py = px[keep], py[keep]

    px, py = jnp.asarray(px), jnp.asarray(py)
    ray = geo.to_ray(prj)(px, py)
    px2, py2 = geo.to_plane(prj)(*ray)
    np.testing.assert_allclose(np.asarray(px), np.asarray(px2),
                               atol=1e-12, rtol=0)
    np.testing.assert_allclose(np.asarray(py), np.asarray(py2),
                               atol=1e-12, rtol=0)


def test_ray_to_cubeface_consistency():
    x, y, z = random_rays()
    face, fx, fy = geo.ray_to_cubeface(x, y, z)
    # in-face coordinates are within [-1, 1]
    assert np.all(np.abs(np.asarray(fx)) <= 1.0 + 1e-12)
    assert np.all(np.abs(np.asarray(fy)) <= 1.0 + 1e-12)
    # reconstructing the ray from (face, in-face) matches the input
    x2, y2, z2 = geo.normalize(*geo.in_face_to_ray(face, fx, fy))
    for a, b in zip((x, y, z), (x2, y2, z2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-12)
    # the fixed-face variant agrees with the free variant on its face
    fx2, fy2 = geo.ray_to_cubeface_fixed(x, y, z, face)
    np.testing.assert_allclose(np.asarray(fx), np.asarray(fx2), atol=1e-12)
    np.testing.assert_allclose(np.asarray(fy), np.asarray(fy2), atol=1e-12)


def test_cubeface_dominant_axis_numbering():
    # face >> 1 must give the dominant axis: 0->x, 1->y, 2->z
    probes = {
        (1.0, 0.1, 0.2): 1,   # RIGHT
        (-1.0, 0.1, 0.2): 0,  # LEFT
        (0.1, -1.0, 0.2): 2,  # TOP
        (0.1, 1.0, 0.2): 3,   # BOTTOM
        (0.1, 0.2, 1.0): 4,   # FRONT
        (0.1, 0.2, -1.0): 5,  # BACK
    }
    for (x, y, z), expected in probes.items():
        face, _, _ = geo.ray_to_cubeface(
            jnp.asarray([x]), jnp.asarray([y]), jnp.asarray([z]))
        assert int(face[0]) == expected
