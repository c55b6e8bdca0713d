"""Rotation convention tests against Imath ground truth.

tests/data/imath_rotation_truth.json was generated on this machine with
the system Imath library, replicating the reference's rotate_3d /
make_r3_t exactly (Euler ZXY quaternion, envutil_payload.cc:136-218).
Each record holds the three rotated basis vectors ('rows', the r3_t
representation); our standard matrix R satisfies R[:, i] == rows[i].
"""

import json
import math
import pathlib

import numpy as np

from envutil.core.rotation import camera_to_facet, rotation_rpy

DATA = pathlib.Path(__file__).parent / "data" / "imath_rotation_truth.json"


def test_rotation_matches_imath():
    records = json.loads(DATA.read_text())
    for rec in records:
        r, p, y = rec["rpy"]
        rows = np.array(rec["rows"])
        expected = rows.T  # columns = rotated basis vectors
        got = rotation_rpy(r, p, y, inverse=bool(rec["inverse"]))
        np.testing.assert_allclose(got, expected, atol=1e-13)


def test_rotation_is_orthonormal():
    r = rotation_rpy(0.3, -1.2, 2.5)
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-14)
    assert np.linalg.det(r) > 0.999999


def test_yaw_turns_forward_to_the_right():
    # yaw of +90 degrees: the view turns right, so the forward axis
    # (0,0,1) maps to the right axis (1,0,0)
    r = rotation_rpy(0.0, 0.0, math.pi / 2)
    np.testing.assert_allclose(r @ np.array([0.0, 0.0, 1.0]),
                               np.array([1.0, 0.0, 0.0]), atol=1e-15)


def test_pitch_turns_forward_down():
    # pitch of +90 degrees maps forward to up (negative y = up in lux
    # convention corresponds to Imath's positive rotation about x);
    # just pin the convention so regressions are caught:
    r = rotation_rpy(0.0, math.pi / 2, 0.0)
    fwd = r @ np.array([0.0, 0.0, 1.0])
    np.testing.assert_allclose(np.abs(fwd), np.array([0.0, 1.0, 0.0]),
                               atol=1e-15)


def test_camera_to_facet_identity():
    rpy = (0.2, -0.5, 1.1)
    np.testing.assert_allclose(camera_to_facet(rpy, rpy), np.eye(3),
                               atol=1e-14)
