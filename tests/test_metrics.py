"""Extent / step / vfov and cubemap metrics tests (reference:
envutil_basic.cc:50-226, metrics.h:209-376)."""

import math

import numpy as np

from envutil.core.conventions import Projection
from envutil.core.metrics import CubemapMetrics, get_extent, get_step, get_vfov


def test_spherical_extent_full():
    e = get_extent(Projection.SPHERICAL, 4096, 2048, 2 * math.pi)
    assert np.isclose(e.x0, -math.pi) and np.isclose(e.x1, math.pi)
    assert np.isclose(e.y0, -math.pi / 2) and np.isclose(e.y1, math.pi / 2)


def test_rectilinear_extent_90():
    e = get_extent(Projection.RECTILINEAR, 100, 100, math.pi / 2)
    assert np.isclose(e.x0, -1.0) and np.isclose(e.x1, 1.0)
    assert np.isclose(e.y0, -1.0) and np.isclose(e.y1, 1.0)


def test_cubemap_extent_is_1_to_6():
    e = get_extent(Projection.CUBEMAP, 512, 6 * 512, math.pi / 2)
    assert np.isclose(e.x1, 1.0) and np.isclose(e.y1, 6.0)
    assert np.isclose(e.x0, -1.0) and np.isclose(e.y0, -6.0)


def test_step_spherical():
    assert np.isclose(get_step(Projection.SPHERICAL, 3600, 1800,
                               2 * math.pi), 2 * math.pi / 3600)


def test_vfov_rectilinear():
    v = get_vfov(Projection.RECTILINEAR, 1920, 1080, math.pi / 2)
    assert np.isclose(v, 2 * math.atan(1080 * math.tan(math.pi / 4) / 1920))


def test_cubemap_metrics_90_even():
    m = CubemapMetrics.create(512, math.pi / 2, support_min_px=8, tile_px=64)
    # 512 + 2*8 = 528 -> 9 tiles of 64 = 576
    assert m.section_px == 576
    assert m.left_frame_px == 32 and m.right_frame_px == 32
    assert np.isclose(m.model_to_px, 256.0)
    assert np.isclose(m.section_md, 576 / 256.0)
    assert np.isclose(m.refc_md, (32 + 256) / 256.0)
    assert m.left_frame_px + m.right_frame_px + m.face_px == m.section_px


def test_cubemap_metrics_overscan():
    # cube faces with inherent support (fov > 90 deg)
    fov = 2 * math.atan(1.1)
    m = CubemapMetrics.create(550, fov, support_min_px=4, tile_px=1)
    assert m.inherent_support_px == 25  # (tan(fov/2)-1) * 550/(2*1.1) = 25
    # inherent support covers the minimum -> no extra frame beyond layout
    assert m.section_px == 550
    assert m.left_frame_px == 0 and m.right_frame_px == 0


def test_pickup_coordinate_center():
    m = CubemapMetrics.create(512, math.pi / 2, support_min_px=8, tile_px=64)
    # the center of face 0 (in-face 0,0) must land at the center of the
    # first section, in pixel units: refc_md * model_to_px - 0.5
    px, py = m.get_pickup_coordinate_px(0, 0.0, 0.0)
    assert np.isclose(px, 32 + 256 - 0.5)
    assert np.isclose(py, 32 + 256 - 0.5)
    # face 3: shifted down by 3 sections
    px, py = m.get_pickup_coordinate_px(3, 0.0, 0.0)
    assert np.isclose(py, 32 + 256 - 0.5 + 3 * 576)
