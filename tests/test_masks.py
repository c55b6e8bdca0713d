"""PTO 'exclude' polygon mask rasterization parity.

The reference fills k-line mask polygons with a scanline algorithm
using cumulative winding order (envutil_basic.cc:236-321) - unlike
even-odd filling, a self-intersecting star covers its center. These
tests pin that behavior plus the int-truncation convention.
"""

import math

import numpy as np

from envutil.models.environment import _fill_polygon_mask


def test_polygon_fill_convex_box():
    alpha = np.ones((32, 32), np.float32)
    _fill_polygon_mask(alpha, [5, 20, 20, 5], [5, 5, 20, 20])
    # the reference's crossing test (vy[i] < y && vy[j] >= y,
    # envutil_basic.cc:260-263) fills rows 6..20 and columns [5, 20)
    assert alpha[10, 4] == 1.0
    assert alpha[10, 5] == 0.0
    assert alpha[10, 19] == 0.0
    assert alpha[10, 20] == 1.0
    assert alpha[5, 10] == 1.0
    assert alpha[6, 10] == 0.0
    assert alpha[20, 10] == 0.0
    assert alpha[21, 10] == 1.0


def test_polygon_fill_self_intersecting_star():
    # 5-point star drawn edge-to-every-second-vertex: the central
    # pentagon has winding order 2. Panotools-compatible winding fill
    # covers it; even-odd filling would leave it unfilled.
    cx, cy, r = 32.0, 32.0, 28.0
    pts = []
    for k in range(5):
        a = -math.pi / 2 + k * 4 * math.pi / 5
        pts.append((cx + r * math.cos(a), cy + r * math.sin(a)))
    vx = [p[0] for p in pts]
    vy = [p[1] for p in pts]
    alpha = np.ones((64, 64), np.float32)
    _fill_polygon_mask(alpha, vx, vy)
    assert alpha[32, 32] == 0.0, "star center must be filled (winding 2)"
    assert alpha[2, 2] == 1.0, "outside must stay unfilled"
    # a point inside one of the star's triangular tips (winding 1)
    assert alpha[8, 32] == 0.0


def test_polygon_fill_winding_cancel():
    # two opposite-winding overlapping squares: the overlap region's
    # winding sums to zero -> NOT filled, each exclusive part is
    a = [(4, 4), (24, 4), (24, 24), (4, 24)]           # CW in image coords
    b = [(14, 14), (14, 34), (34, 34), (34, 14)]       # CCW
    vx = [p[0] for p in a] + [a[0][0]] + [p[0] for p in b] + [b[0][0]]
    vy = [p[1] for p in a] + [a[0][1]] + [p[1] for p in b] + [b[0][1]]
    alpha = np.ones((40, 40), np.float32)
    _fill_polygon_mask(alpha, vx, vy)
    assert alpha[8, 8] == 0.0          # only in square a
    assert alpha[30, 30] == 0.0        # only in square b
    assert alpha[18, 18] == 1.0        # overlap: winding 1 - 1 = 0
