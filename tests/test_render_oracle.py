"""The single-facet render path against the float64 oracle
(tests/oracle.py), over every target projection and spline degree,
and cubemap / biatan6 sources back to a spherical target - the
face-boundary lookups of the cubemap IR included."""

import math

import numpy as np
import pytest

import oracle as O

from envutil.core.conventions import Projection
from envutil.models import cubemap as CBM
from envutil.models import environment as E

from test_golden_oracle import (GOLDEN_DB, fw_render, make_args,
                                make_facet, synthetic_equirect)

# target projection -> (oracle name, width, height, hfov in degrees)
TARGETS = {
    Projection.SPHERICAL: (O.SPHERICAL, 48, 24, 360.0),
    Projection.CYLINDRICAL: (O.CYLINDRICAL, 48, 32, 240.0),
    Projection.RECTILINEAR: (O.RECTILINEAR, 48, 40, 80.0),
    Projection.STEREOGRAPHIC: (O.STEREOGRAPHIC, 48, 48, 140.0),
    Projection.FISHEYE: (O.FISHEYE, 48, 48, 170.0),
    Projection.CUBEMAP: (O.CUBEMAP, 8, 48, 90.0),
    Projection.BIATAN6: (O.BIATAN6, 8, 48, 90.0),
}
POSE = dict(yaw=30.0, pitch=10.0, roll=5.0)

_ENV = synthetic_equirect(128, 64)
_ORACLES = {}


def _oracle_env(degree):
    if degree not in _ORACLES:
        _ORACLES[degree] = O.MountFacet(O.SPHERICAL, 128, 64, 2 * math.pi,
                                        _ENV, degree=degree)
    return _ORACLES[degree]


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 5, 7])
@pytest.mark.parametrize("prj", list(TARGETS), ids=lambda p: p.name)
def test_render_matches_oracle(prj, degree):
    oprj, w, h, hfov = TARGETS[prj]
    fct = make_facet(Projection.SPHERICAL, 128, 64, 2 * math.pi)
    src = E.make_mount_source(fct, _ENV, degree, degree)
    out = fw_render(make_args(prj, w, h, hfov, [fct], degree=degree,
                              **POSE), [src])
    assert out.shape == (h, w, 3)
    t = dict(projection=oprj, width=w, height=h,
             hfov=math.radians(hfov),
             **{k: math.radians(v) for k, v in POSE.items()})
    p = O.psnr(out, O.render(t, [_oracle_env(degree)]))
    assert p > GOLDEN_DB, f"{prj.name} degree {degree}: {p:.1f} dB"


def _faces(face_px):
    """Smooth per-face content: distinct on each face, so a lookup
    that reads the wrong section shows."""
    i = (np.arange(face_px) + 0.5) / face_px
    u, v = np.meshgrid(i, i)
    faces = np.stack([np.stack([0.5 + 0.4 * np.sin(2 * u + f),
                                0.5 + 0.4 * np.cos(3 * v - f),
                                0.2 + 0.1 * f + 0.1 * u * v], -1)
                      for f in range(6)])
    return faces.astype(np.float32)


@pytest.mark.parametrize("degree", [1, 3])
@pytest.mark.parametrize("prj", [Projection.CUBEMAP, Projection.BIATAN6],
                         ids=lambda p: p.name)
def test_cubeface_source_to_spherical_matches_oracle(prj, degree):
    face = 64
    faces = _faces(face)
    cfct = make_facet(prj, face, 6 * face, math.pi / 2)
    csrc = CBM.make_cubemap_source(cfct, faces, degree, degree,
                                   support_min=8, tile_size=64)
    out = fw_render(make_args(Projection.SPHERICAL, 96, 48, 360.0,
                              [cfct], degree=degree, **POSE), [csrc])
    ocf = O.CubemapFacet(O.CUBEMAP if prj == Projection.CUBEMAP
                         else O.BIATAN6, face, math.pi / 2,
                         faces.reshape(6 * face, face, 3), degree=degree)
    t = dict(projection=O.SPHERICAL, width=96, height=48,
             hfov=2 * math.pi,
             **{k: math.radians(v) for k, v in POSE.items()})
    p = O.psnr(out, O.render(t, [ocf]))
    assert p > GOLDEN_DB, f"{prj.name} degree {degree}: {p:.1f} dB"
