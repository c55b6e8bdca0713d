"""Transform-chain property tests mirroring geometry.cc's remaining
blocks: steppers vs. reference rotation (geometry.cc:185-313),
pto_planar forward∘inverse identity (geometry.cc:990-1020), and
tf3d∘tf3d⁻¹ identity (geometry.cc:1022-1047)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from envutil.core import geometry as geo
from envutil.core.conventions import Projection
from envutil.core.facet import Facet
from envutil.core.metrics import get_extent
from envutil.core.rotation import camera_to_facet, rotation_rpy
from envutil.models import lens as L
from envutil.models import stepper as ST
from envutil.runtime.render import _tf3d, generic_r3

RNG = np.random.default_rng(11)


@pytest.mark.parametrize("prj", [Projection.SPHERICAL,
                                 Projection.CYLINDRICAL,
                                 Projection.RECTILINEAR,
                                 Projection.STEREOGRAPHIC,
                                 Projection.FISHEYE,
                                 Projection.CUBEMAP,
                                 Projection.BIATAN6])
def test_stepper_equals_plane_to_ray_plus_rotation(prj):
    """A rotated stepper must equal: planar grid -> plane-to-ray ->
    rotation (the reference checks its row-invariant stepper
    optimizations against quaternion rotation the same way)."""
    w = h = 64
    if prj in (Projection.CUBEMAP, Projection.BIATAN6):
        h = 6 * w
        hfov = math.radians(100)
    elif prj == Projection.SPHERICAL:
        hfov = 2 * math.pi
        h = w // 2
    else:
        hfov = math.radians(80)
    extent = get_extent(prj, w, h, hfov)
    basis = camera_to_facet((0.2, -0.4, 1.0), (0.5, 0.1, -0.3))

    got = ST.target_rays(prj, w, h, extent, basis=basis, normalize=True)

    px, py = ST.planar_grid(w, h, extent, dtype=np.float64)
    section = extent.x1 - extent.x0
    raw = geo.to_ray(prj, section_md=section, refc_md=section / 2)(px, py)
    expect = geo.normalize(*geo.apply_matrix(basis, *raw))

    for g, e in zip(got, expect):
        np.testing.assert_allclose(np.asarray(g), np.asarray(e),
                                   atol=2e-6)


def test_pto_planar_forward_inverse_identity():
    fct = Facet()
    fct.set_geometry(Projection.RECTILINEAR, 200, 150, math.radians(70))
    fct.a, fct.b, fct.c = 0.02, -0.015, 0.01
    fct.h, fct.v = 12.0, -8.0     # pixels, converted by process_geometry
    fct.shear_g, fct.shear_t = 0.01, -0.02
    fct.process_geometry()

    fwd = L.pto_planar_forward(fct)
    inv = L.pto_planar_inverse(fct)

    n = 2000
    px = jnp.asarray(RNG.uniform(fct.x0, fct.x1, n), jnp.float32)
    py = jnp.asarray(RNG.uniform(fct.y0, fct.y1, n), jnp.float32)
    fx, fy = fwd(px, py)
    bx, by = inv(fx, fy)
    # reference asserts 1e-6 at double precision; we run f32
    np.testing.assert_allclose(np.asarray(bx), np.asarray(px), atol=3e-4)
    np.testing.assert_allclose(np.asarray(by), np.asarray(py), atol=3e-4)


def test_inverse_lcp_accuracy():
    inv = L.InverseLcp.create(0.05, -0.03, 0.02, r_max=1.5, sz=100)
    r = np.linspace(0.01, 1.4, 200)
    scale = np.asarray(L.lcp_scale(jnp.asarray(r), 0.05, -0.03, 0.02))
    rr = r * scale
    factor = np.asarray(inv(jnp.asarray(rr, jnp.float32)))
    np.testing.assert_allclose(rr * factor, r, atol=2e-5)


def test_tf3d_roundtrip():
    """tf3d with shift followed by its inverse chain restores the ray
    direction (geometry.cc:1022-1047 asserts 1e-7 over a grid)."""
    r1 = rotation_rpy(0.3, -0.2, 0.7)
    r2 = rotation_rpy(-0.1, 0.5, 0.2)
    shift = np.array([0.1, -0.2, 0.15])
    fwd = _tf3d(r1, r2, shift, dcp=1.0)

    n = 1000
    v = RNG.normal(size=(3, n))
    v[2] = np.abs(v[2]) + 0.5
    v /= np.linalg.norm(v, axis=0)
    # keep rays in front of the reprojection plane (behind-plane rays
    # are poisoned with -inf by design)
    v = v[:, (r1 @ v)[2] > 0.05]
    x, y, z = (jnp.asarray(c, jnp.float64) for c in v)
    fx, fy, fz = fwd(x, y, z)
    # manual inverse of the forward chain
    ix, iy, iz = geo.apply_matrix(r2.T, fx, fy, fz)
    ix = ix + shift[0]
    iy = iy + shift[1]
    iz = iz + shift[2]
    ix, iy, iz = geo.apply_matrix(r1.T, ix, iy, iz)
    ix, iy, iz = geo.normalize(ix, iy, iz)
    for got, want in zip((ix, iy, iz), (x, y, z)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-7)


def test_generic_r3_no_translation_equals_rotation():
    ft = Facet(yaw=0.3, pitch=-0.1, roll=0.2)
    fs = Facet(yaw=-0.5, pitch=0.4, roll=0.0)
    fn = generic_r3(ft, fs)
    expect_m = rotation_rpy(fs.roll, fs.pitch, fs.yaw).T \
        @ rotation_rpy(ft.roll, ft.pitch, ft.yaw)
    v = RNG.normal(size=(3, 100))
    x, y, z = (jnp.asarray(c) for c in v)
    got = fn(x, y, z)
    want = geo.apply_matrix(expect_m, x, y, z)
    for g, e in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(e),
                                   atol=1e-6)


def test_generic_r3_translation_poisons_backside():
    """Rays behind the reprojection plane get z=-inf
    (geometry.h:1904-1935)."""
    fs = Facet(tr_x=0.2, tr_y=0.0, tr_z=0.1)
    fs.set_geometry(Projection.RECTILINEAR, 64, 64, 1.0)
    fs.process_geometry()
    ft = Facet()
    fn = generic_r3(ft, fs)
    x, y, z = (jnp.asarray([0.0]), jnp.asarray([0.0]),
               jnp.asarray([-1.0]))
    _, _, pz = fn(x, y, z)
    assert np.isneginf(np.asarray(pz))[0]
