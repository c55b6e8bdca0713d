"""End-to-end render tests on synthetic fixtures (small sizes for CPU).

These play the role of the reference's stepper.cc demo renders and the
round-trip verification in geometry.cc, but assert numerically:
* extraction from a synthetic equirect with known content,
* equirect -> cubemap -> equirect round trip at high PSNR,
* voronoi facet selection,
* twining ~= supersampled box average.
"""

import math

import numpy as np
import pytest

from envutil.core.conventions import Projection
from envutil.core.facet import Facet
from envutil.core.metrics import get_extent, get_step
from envutil.models import environment as E
from envutil.models import cubemap as CBM
from envutil.models import synopsis as SYN
from envutil.models import stepper as ST
from envutil.runtime.render import RenderPlan, build_plan, render_frame
from envutil.runtime.args import Args

RNG = np.random.default_rng(3)


def synthetic_equirect(w=256, h=128):
    lon = (np.arange(w) + 0.5) / w * 2 * math.pi - math.pi
    lat = (np.arange(h) + 0.5) / h * math.pi - math.pi / 2
    img = np.zeros((h, w, 3), np.float32)
    img[..., 0] = 0.5 + 0.5 * np.sin(3 * lon[None, :]) * np.cos(lat[:, None])
    img[..., 1] = 0.5 + 0.5 * np.cos(2 * lon[None, :]) * np.cos(2 * lat[:, None])
    img[..., 2] = 0.5 + 0.5 * np.sin(lat[:, None])
    return img


def make_facet(projection, w, h, hfov, **kw):
    f = Facet(facet_no=0, nchannels=3)
    f.set_geometry(projection, w, h, hfov)
    f.step = get_step(projection, w, h, hfov)
    f.process_geometry()
    for k, v in kw.items():
        setattr(f, k, v)
    return f


def make_args(projection, w, h, hfov_deg, facets, degree=1, twine=0,
              synopsis="panorama", yaw=0.0, pitch=0.0, roll=0.0,
              nchannels=3):
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
    a.twine = twine
    a.synopsis = synopsis
    a.nchannels = nchannels
    a.facets = facets
    if len(facets) == 1:
        a.solo = 0
    if twine:
        a.twine_spread = [(-0.25, -0.25, 0.25), (0.25, -0.25, 0.25),
                          (-0.25, 0.25, 0.25), (0.25, 0.25, 0.25)]
    return a


def psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 10 * math.log10(1.0 / mse) if mse > 0 else 999.0


def test_extract_rectilinear_from_equirect():
    img = synthetic_equirect()
    fct = make_facet(Projection.SPHERICAL, 256, 128, 2 * math.pi)
    src = E.make_mount_source(fct, img, 1, 1)
    args = make_args(Projection.RECTILINEAR, 64, 64, 60.0, [fct], yaw=45.0)
    plan = build_plan(args, [fct])
    out = render_frame(plan, [src])
    # analytic check at the view center: ray (yaw 45) -> lon=pi/4, lat=0
    lon, lat = math.pi / 4, 0.0
    expect = [0.5 + 0.5 * math.sin(3 * lon) * math.cos(lat),
              0.5 + 0.5 * math.cos(2 * lon) * math.cos(2 * lat),
              0.5 + 0.5 * math.sin(lat)]
    np.testing.assert_allclose(out[32, 32], expect, atol=0.02)


def test_equirect_cubemap_roundtrip():
    img = synthetic_equirect(512, 256)
    fct = make_facet(Projection.SPHERICAL, 512, 256, 2 * math.pi)
    src = E.make_mount_source(fct, img, 3, 3)
    # render a cubemap from the equirect
    args = make_args(Projection.CUBEMAP, 128, 6 * 128, 90.0, [fct],
                     degree=3)
    plan = build_plan(args, [fct])
    cbm_img = render_frame(plan, [src])
    assert cbm_img.shape == (768, 128, 3)

    # mount the cubemap and render back to equirect
    cfct = make_facet(Projection.CUBEMAP, 128, 768, math.pi / 2)
    csrc = CBM.make_cubemap_source(cfct, cbm_img.reshape(6, 128, 128, 3),
                                   3, 3, support_min=8, tile_size=64)
    args2 = make_args(Projection.SPHERICAL, 512, 256, 360.0, [cfct],
                      degree=3)
    plan2 = build_plan(args2, [cfct])
    back = render_frame(plan2, [csrc])
    # interior rows (away from the poles where the equirect is
    # degenerate and resolution differs)
    p = psnr(back[48:-48], img[48:-48])
    assert p > 38.0, f"round-trip PSNR too low: {p:.1f} dB"


def test_voronoi_champion_selection():
    # two overlapping rectilinear facets: the pixel straight ahead must
    # come from the facet whose center is closer to the view axis
    base = synthetic_equirect()
    fct_env = make_facet(Projection.SPHERICAL, 256, 128, 2 * math.pi)

    red = np.zeros((64, 64, 3), np.float32)
    red[..., 0] = 1.0
    green = np.zeros((64, 64, 3), np.float32)
    green[..., 1] = 1.0
    f0 = make_facet(Projection.RECTILINEAR, 64, 64, math.pi / 2, yaw=0.1)
    f0.facet_no = 0
    f1 = make_facet(Projection.RECTILINEAR, 64, 64, math.pi / 2, yaw=0.6)
    f1.facet_no = 1
    s0 = E.make_mount_source(f0, red, 1, 1)
    s1 = E.make_mount_source(f1, green, 1, 1)

    args = make_args(Projection.RECTILINEAR, 32, 32, 90.0, [f0, f1])
    args.solo = -1
    plan = build_plan(args, [f0, f1])
    out = render_frame(plan, [s0, s1])
    # straight ahead (center): f0 (yaw 0.1) is closer -> red
    np.testing.assert_allclose(out[16, 16], [1, 0, 0], atol=1e-5)
    # far right edge: f1 wins -> green
    np.testing.assert_allclose(out[16, -1], [0, 1, 0], atol=1e-5)


def test_hdr_merge_two_exposures():
    # two identical-content exposures one stop apart; merged output
    # should roughly reproduce the scene at the mean Eev
    scene = synthetic_equirect()
    dark = (scene * 0.5).astype(np.float32)
    f0 = make_facet(Projection.SPHERICAL, 256, 128, 2 * math.pi)
    f0.brighten = 2.0 ** (-0.5)   # Eev below mean
    f1 = make_facet(Projection.SPHERICAL, 256, 128, 2 * math.pi)
    f1.facet_no = 1
    f1.brighten = 2.0 ** (0.5)
    s0 = E.make_mount_source(f0, scene, 1, 1)
    s1 = E.make_mount_source(f1, dark, 1, 1)
    args = make_args(Projection.RECTILINEAR, 32, 32, 60.0, [f0, f1],
                     synopsis="hdr_merge")
    args.solo = -1
    plan = build_plan(args, [f0, f1])
    out = render_frame(plan, [s0, s1])
    assert np.all(np.isfinite(out))
    # the merge is a quality-weighted mean of brightened exposures:
    # scene*2^-0.5 and scene*0.5*2^0.5 = scene*2^-0.5 -> out ~ scene*0.707
    args_solo = make_args(Projection.RECTILINEAR, 32, 32, 60.0, [f0])
    plan_solo = build_plan(args_solo, [f0])
    ref = render_frame(plan_solo, [s0])
    np.testing.assert_allclose(out, ref, atol=0.01)


def test_twining_antialias_is_box_average():
    # a downscale with twining must approximate the plain render's
    # box-filtered supersampling
    img = synthetic_equirect(512, 256)
    fct = make_facet(Projection.SPHERICAL, 512, 256, 2 * math.pi)
    src = E.make_mount_source(fct, img, 1, 1)
    args = make_args(Projection.RECTILINEAR, 32, 32, 70.0, [fct],
                     twine=2)
    plan = build_plan(args, [fct])
    small = render_frame(plan, [src])

    args_big = make_args(Projection.RECTILINEAR, 64, 64, 70.0, [fct])
    plan_big = build_plan(args_big, [fct])
    big = render_frame(plan_big, [src])
    box = big.reshape(32, 2, 32, 2, 3).mean(axis=(1, 3))
    assert psnr(small, box) > 30.0


def test_alpha_compositing_voronoi_plus():
    # a semi-transparent facet over an opaque one: result must blend
    rgba_top = np.zeros((64, 64, 4), np.float32)
    rgba_top[..., 0] = 0.5   # associated alpha: red 0.5, alpha 0.5
    rgba_top[..., 3] = 0.5
    rgba_bot = np.zeros((64, 64, 4), np.float32)
    rgba_bot[..., 1] = 1.0
    rgba_bot[..., 3] = 1.0
    f0 = make_facet(Projection.RECTILINEAR, 64, 64, 1.0)  # wins (hi-res)
    f1 = make_facet(Projection.RECTILINEAR, 64, 64, math.pi / 2)
    f1.facet_no = 1
    f0.nchannels = f1.nchannels = 4
    s0 = E.make_mount_source(f0, rgba_top, 1, 1)
    s1 = E.make_mount_source(f1, rgba_bot, 1, 1)
    args = make_args(Projection.RECTILINEAR, 16, 16, 60.0, [f0, f1],
                     nchannels=4)
    args.solo = -1
    plan = build_plan(args, [f0, f1])
    out = render_frame(plan, [s0, s1])
    np.testing.assert_allclose(out[8, 8], [0.5, 0.5, 0.0, 1.0], atol=1e-5)
