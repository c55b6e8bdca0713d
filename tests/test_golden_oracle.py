"""Golden verification against the independent float64 oracle.

BASELINE.json's north star demands >= 50 dB PSNR vs the reference's
output. The reference binary cannot be built in this image (no
OpenImageIO), so tests/oracle.py re-implements the reference pipeline
from the reference sources in naive numpy float64, sharing no code with
envutil. These tests render small versions of all five BASELINE
configs through BOTH pipelines and assert agreement far above the
50 dB bar — a systematic error on either side (e.g. a half-pixel
convention slip) would show up as a PSNR collapse.

Configs (BASELINE.md):
  1. lat/lon -> rectilinear, degree 1 and 3
  2. equirect -> cubemap (deg 3 + prefilter) and reverse
  3. biatan6 -> stereographic / fisheye with yaw/pitch/roll
  4. twining anti-aliased downscale (explicit box spread)
  5. multi-facet voronoi + lens correction; 3-bracket HDR merge
"""

import math

import numpy as np
import pytest

import oracle as O

from envutil.core.conventions import Projection
from envutil.core.facet import Facet
from envutil.core.metrics import get_extent, get_step
from envutil.models import cubemap as CBM
from envutil.models import environment as E
from envutil.runtime.args import Args
from envutil.runtime.render import build_plan, render_frame

GOLDEN_DB = 50.0


def synthetic_equirect(w=256, h=128):
    lon = (np.arange(w) + 0.5) / w * 2 * math.pi - math.pi
    lat = (np.arange(h) + 0.5) / h * math.pi - math.pi / 2
    img = np.zeros((h, w, 3), np.float32)
    img[..., 0] = 0.5 + 0.4 * np.sin(3 * lon[None, :]) * np.cos(lat[:, None])
    img[..., 1] = 0.5 + 0.4 * np.cos(2 * lon[None, :]) * np.cos(2 * lat[:, None])
    img[..., 2] = 0.5 + 0.4 * np.sin(lat[:, None])
    return img


def make_facet(projection, w, h, hfov, no=0, **kw):
    f = Facet(facet_no=no, nchannels=3)
    f.set_geometry(projection, w, h, hfov)
    f.step = get_step(projection, w, h, hfov)
    for k, v in kw.items():
        setattr(f, k, v)
    f.process_geometry()
    return f


def make_args(projection, w, h, hfov_deg, facets, degree=1, yaw=0.0,
              pitch=0.0, roll=0.0, synopsis="panorama", twine_spread=None):
    a = Args()
    a.projection = projection
    a.width, a.height = w, h
    a.hfov = hfov_deg * math.pi / 180.0
    a.extent = get_extent(projection, w, h, a.hfov)
    a.step = (a.extent.x1 - a.extent.x0) / w
    a.yaw = yaw * math.pi / 180
    a.pitch = pitch * math.pi / 180
    a.roll = roll * math.pi / 180
    a.spline_degree = degree
    a.prefilter_degree = degree
    a.twine = 0
    a.synopsis = synopsis
    a.nchannels = 3
    a.facets = facets
    a.solo = 0 if len(facets) == 1 else -1
    if twine_spread:
        a.twine = 1
        a.twine_spread = twine_spread
    return a


def fw_render(args, srcs):
    plan = build_plan(args, args.facets)
    return np.asarray(render_frame(plan, srcs))


@pytest.fixture(scope="module")
def env():
    return synthetic_equirect()


@pytest.fixture(scope="module")
def env_facet():
    return make_facet(Projection.SPHERICAL, 256, 128, 2 * math.pi)


@pytest.fixture(scope="module")
def env_src3(env, env_facet):
    return E.make_mount_source(env_facet, env, 3, 3)


@pytest.fixture(scope="module")
def oracle_env3(env):
    return O.MountFacet(O.SPHERICAL, 256, 128, 2 * math.pi, env, degree=3)


# ---------------------------------------------------------- config 1

@pytest.mark.parametrize("degree", [1, 3])
def test_golden_latlon_to_rectilinear(env, env_facet, degree):
    src = E.make_mount_source(env_facet, env, degree, degree)
    args = make_args(Projection.RECTILINEAR, 96, 64, 75.0, [env_facet],
                     degree=degree, yaw=30.0, pitch=10.0, roll=5.0)
    out = fw_render(args, [src])
    ofct = O.MountFacet(O.SPHERICAL, 256, 128, 2 * math.pi, env,
                        degree=degree)
    t = dict(projection=O.RECTILINEAR, width=96, height=64,
             hfov=75 * math.pi / 180, yaw=30 * math.pi / 180,
             pitch=10 * math.pi / 180, roll=5 * math.pi / 180)
    p = O.psnr(out, O.render(t, [ofct]))
    assert p > GOLDEN_DB, f"deg-{degree} extract: {p:.1f} dB"


# ---------------------------------------------------------- config 2

def test_golden_equirect_to_cubemap(env, env_facet, env_src3, oracle_env3):
    args = make_args(Projection.CUBEMAP, 64, 384, 90.0, [env_facet],
                     degree=3)
    cbm = fw_render(args, [env_src3])
    t = dict(projection=O.CUBEMAP, width=64, height=384, hfov=math.pi / 2)
    p = O.psnr(cbm, O.render(t, [oracle_env3]))
    assert p > GOLDEN_DB, f"eq->cubemap: {p:.1f} dB"


def test_golden_cubemap_to_equirect(env, env_facet, env_src3):
    args = make_args(Projection.CUBEMAP, 64, 384, 90.0, [env_facet],
                     degree=3)
    cbm = fw_render(args, [env_src3])
    cfct = make_facet(Projection.CUBEMAP, 64, 384, math.pi / 2)
    csrc = CBM.make_cubemap_source(cfct, cbm.reshape(6, 64, 64, 3), 3, 3,
                                   support_min=8, tile_size=64)
    args2 = make_args(Projection.SPHERICAL, 256, 128, 360.0, [cfct],
                      degree=3)
    back = fw_render(args2, [csrc])
    ocf = O.CubemapFacet(O.CUBEMAP, 64, math.pi / 2,
                         cbm.reshape(384, 64, 3), degree=3)
    t = dict(projection=O.SPHERICAL, width=256, height=128,
             hfov=2 * math.pi)
    p = O.psnr(back, O.render(t, [ocf]))
    assert p > GOLDEN_DB, f"cubemap->eq: {p:.1f} dB"


# ---------------------------------------------------------- config 3

@pytest.mark.parametrize("prj,oprj", [
    (Projection.STEREOGRAPHIC, O.STEREOGRAPHIC),
    (Projection.FISHEYE, O.FISHEYE),
])
def test_golden_biatan6_views(env, env_facet, env_src3, prj, oprj):
    args = make_args(Projection.BIATAN6, 64, 384, 90.0, [env_facet],
                     degree=3)
    ba6 = fw_render(args, [env_src3])
    bfct = make_facet(Projection.BIATAN6, 64, 384, math.pi / 2)
    bsrc = CBM.make_cubemap_source(bfct, ba6.reshape(6, 64, 64, 3), 3, 3,
                                   support_min=8, tile_size=64)
    obf = O.CubemapFacet(O.BIATAN6, 64, math.pi / 2,
                         ba6.reshape(384, 64, 3), degree=3)
    args2 = make_args(prj, 96, 64, 120.0, [bfct], degree=3,
                      yaw=25.0, pitch=-15.0, roll=10.0)
    out = fw_render(args2, [bsrc])
    t = dict(projection=oprj, width=96, height=64,
             hfov=120 * math.pi / 180, yaw=25 * math.pi / 180,
             pitch=-15 * math.pi / 180, roll=10 * math.pi / 180)
    p = O.psnr(out, O.render(t, [obf]))
    assert p > GOLDEN_DB, f"biatan6->{oprj}: {p:.1f} dB"


# ---------------------------------------------------------- config 4

def test_golden_twining(env, env_facet):
    spread = O.make_spread(2, 2, 1.0)
    src = E.make_mount_source(env_facet, env, 1, 1)
    args = make_args(Projection.RECTILINEAR, 48, 32, 70.0, [env_facet],
                     degree=1, yaw=40.0, twine_spread=spread)
    out = fw_render(args, [src])
    ofct = O.MountFacet(O.SPHERICAL, 256, 128, 2 * math.pi, env, degree=1)
    t = dict(projection=O.RECTILINEAR, width=48, height=32,
             hfov=70 * math.pi / 180, yaw=40 * math.pi / 180)
    p = O.psnr(out, O.render(t, [ofct], spread=spread))
    assert p > GOLDEN_DB, f"twined downscale: {p:.1f} dB"


def test_golden_twine_precise(env, env_facet):
    """--twine_precise: tangent-plane derivative basis
    (twining.h:152-263, selected at environment.h:1997). The flag
    must (a) agree with the oracle's independent float64
    deriv_tangential implementation and (b) actually change the
    output vs plain differencing."""
    spread = O.make_spread(3, 3, 1.0)
    src = E.make_mount_source(env_facet, env, 1, 1)
    args = make_args(Projection.RECTILINEAR, 48, 32, 70.0, [env_facet],
                     degree=1, yaw=40.0, pitch=25.0,
                     twine_spread=spread)
    args.twine_precise = True
    out = fw_render(args, [src])
    ofct = O.MountFacet(O.SPHERICAL, 256, 128, 2 * math.pi, env,
                        degree=1)
    t = dict(projection=O.RECTILINEAR, width=48, height=32,
             hfov=70 * math.pi / 180, yaw=40 * math.pi / 180,
             pitch=25 * math.pi / 180)
    p = O.psnr(out, O.render(t, [ofct], spread=spread,
                             twine_precise=True))
    assert p > GOLDEN_DB, f"twine_precise: {p:.1f} dB"
    # the flag is not inert: plain differencing measurably differs
    args.twine_precise = False
    out_plain = fw_render(args, [src])
    assert not np.array_equal(out, out_plain)
    # ... but only slightly (the reference documents the difference
    # as negligible for sane spreads - sanity-bound it)
    assert O.psnr(out, out_plain) > 30.0


# ---------------------------------------------------------- config 5

def test_golden_voronoi_with_lens(env, env_facet, env_src3):
    yaws = (-60.0, -20.0, 20.0, 60.0)
    pitches = (10.0, -10.0, 10.0, -10.0)
    fimgs = []
    for yw, pt in zip(yaws, pitches):
        a = make_args(Projection.RECTILINEAR, 80, 80, 70.0, [env_facet],
                      degree=3, yaw=yw, pitch=pt)
        fimgs.append(fw_render(a, [env_src3]))

    lens = dict(a=0.0, b=-0.05, c=0.01)
    facets, ofacets, srcs = [], [], []
    for i, (yw, pt, fim) in enumerate(zip(yaws, pitches, fimgs)):
        f = make_facet(Projection.RECTILINEAR, 80, 80,
                       70 * math.pi / 180, no=i,
                       yaw=yw * math.pi / 180, pitch=pt * math.pi / 180,
                       **lens)
        facets.append(f)
        srcs.append(E.make_mount_source(f, fim, 3, 3))
        ext = O.get_extent(O.RECTILINEAR, 80, 80, 70 * math.pi / 180)
        ol = O.Lens(extent=ext, width=80, **lens)
        ofacets.append(O.MountFacet(
            O.RECTILINEAR, 80, 80, 70 * math.pi / 180, fim,
            yaw=yw * math.pi / 180, pitch=pt * math.pi / 180,
            degree=3, lens=ol))
    args = make_args(Projection.SPHERICAL, 192, 96, 160.0, facets,
                     degree=3)
    out = fw_render(args, srcs)
    t = dict(projection=O.SPHERICAL, width=192, height=96,
             hfov=160 * math.pi / 180)
    p = O.psnr(out, O.render(t, ofacets))
    assert p > GOLDEN_DB, f"voronoi+lens stitch: {p:.1f} dB"


def test_golden_hdr_merge(env):
    brs = [0.5, 1.0, 2.0]
    facets, ofacets, srcs = [], [], []
    for i, b in enumerate(brs):
        im = np.clip(env / b, 0, 10).astype(np.float32)
        f = make_facet(Projection.SPHERICAL, 256, 128, 2 * math.pi, no=i)
        f.brighten = b
        facets.append(f)
        srcs.append(E.make_mount_source(f, im, 3, 3))
        ofacets.append(O.MountFacet(O.SPHERICAL, 256, 128, 2 * math.pi,
                                    im, degree=3, brighten=b))
    args = make_args(Projection.RECTILINEAR, 64, 48, 80.0, facets,
                     degree=3, yaw=30.0, synopsis="hdr_merge")
    out = fw_render(args, srcs)
    t = dict(projection=O.RECTILINEAR, width=64, height=48,
             hfov=80 * math.pi / 180, yaw=30 * math.pi / 180)
    p = O.psnr(out, O.render(t, ofacets, synopsis="hdr_merge"))
    assert p > GOLDEN_DB, f"hdr merge: {p:.1f} dB"


# ----------------------------------------- twined per-tap semantics

def test_golden_twined_partial_facet(env, env_facet, env_src3):
    """Solo twined render of a PARTIAL facet: each tap is weighted by
    the tap's own deflected validity (synopsis_t per-tap masking over
    one facet). Grounds the semantics the fused core/band
    decomposition reproduces."""
    a0 = make_args(Projection.RECTILINEAR, 96, 96, 70.0, [env_facet],
                   degree=3, yaw=25.0)
    fim = fw_render(a0, [env_src3])

    f = make_facet(Projection.RECTILINEAR, 96, 96,
                   70 * math.pi / 180, yaw=25 * math.pi / 180)
    src = E.make_mount_source(f, fim, 3, 3)
    spread = O.make_spread(2, 2, 1.0)
    # the 80-deg view clips the facet: its edge band is in-frame
    args = make_args(Projection.RECTILINEAR, 64, 48, 80.0, [f],
                     degree=3, yaw=10.0, twine_spread=spread)
    out = fw_render(args, [src])

    of = O.MountFacet(O.RECTILINEAR, 96, 96, 70 * math.pi / 180, fim,
                      yaw=25 * math.pi / 180, degree=3)
    t = dict(projection=O.RECTILINEAR, width=64, height=48,
             hfov=80 * math.pi / 180, yaw=10 * math.pi / 180)
    p = O.psnr(out, O.render(t, [of], spread=spread))
    assert p > GOLDEN_DB, f"twined partial facet: {p:.1f} dB"


def test_golden_twined_voronoi(env, env_facet, env_src3):
    """Twined two-facet voronoi: per tap, ALL facets' rays deflect,
    champion is re-selected, and the taps weight-sum (synopsis_t,
    envutil_payload.cc:587-691). Grounds the semantics the fused
    champion-stable decomposition reproduces."""
    yaws = (-20.0, 20.0)
    fims, facets, ofacets, srcs = [], [], [], []
    for i, yw in enumerate(yaws):
        a = make_args(Projection.RECTILINEAR, 96, 96, 70.0,
                      [env_facet], degree=3, yaw=yw)
        fim = fw_render(a, [env_src3])
        f = make_facet(Projection.RECTILINEAR, 96, 96,
                       70 * math.pi / 180, no=i,
                       yaw=yw * math.pi / 180)
        facets.append(f)
        srcs.append(E.make_mount_source(f, fim, 3, 3))
        ofacets.append(O.MountFacet(
            O.RECTILINEAR, 96, 96, 70 * math.pi / 180, fim,
            yaw=yw * math.pi / 180, degree=3))
    spread = O.make_spread(2, 2, 1.0)
    args = make_args(Projection.SPHERICAL, 96, 48, 100.0, facets,
                     degree=3, twine_spread=spread)
    out = fw_render(args, srcs)
    t = dict(projection=O.SPHERICAL, width=96, height=48,
             hfov=100 * math.pi / 180)
    p = O.psnr(out, O.render(t, ofacets, spread=spread))
    assert p > GOLDEN_DB, f"twined voronoi: {p:.1f} dB"
