"""Coverage for shipped I/O surfaces that previously had no tests:

* ``%s`` cubeface-series output + input (six separate face files,
  envutil_basic.h:726-757 / cubemap.h:1147-1215) - round-tripped
  against the 1:6 stripe path.
* the camera-RAW input contract (``raw:*`` --oiio keys -> rawpy
  postprocess arguments, envutil_basic.h:843-905) - pinned with a
  fake rawpy module, since rawpy is not installed in this image.
"""

import math
import sys
import types

import numpy as np
import pytest

from envutil.io import imgio
from envutil.runtime import assets
from envutil.runtime.cli import core


@pytest.fixture(autouse=True)
def _clear_assets():
    assets.cache.clear()
    yield
    assets.cache.clear()


def synthetic_equirect(w=256, h=128):
    lon = (np.arange(w) + 0.5) / w * 2 * math.pi - math.pi
    lat = (np.arange(h) + 0.5) / h * math.pi - math.pi / 2
    img = np.zeros((h, w, 3), np.float32)
    img[..., 0] = 0.5 + 0.4 * np.sin(3 * lon[None, :]) * np.cos(lat[:, None])
    img[..., 1] = 0.5 + 0.4 * np.cos(2 * lon[None, :]) * np.cos(2 * lat[:, None])
    img[..., 2] = 0.5 + 0.4 * np.sin(lat[:, None])
    return img


def psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64)
                   - np.asarray(b, np.float64)) ** 2)
    return 10 * math.log10(1.0 / mse) if mse > 0 else 999.0


# ---------------------------------------------------------------------------
# %s cubeface series
# ---------------------------------------------------------------------------

def test_cubeface_series_roundtrip(tmp_path):
    """Writing a cubemap with '%s' in the path produces six face files;
    reading them back through an '%s' input renders identically to the
    1:6 stripe (the two load paths build the same IR spline)."""
    from envutil.core.conventions import FACE_NAMES

    env = synthetic_equirect()
    imgio.save_image(str(tmp_path / "env.exr"), env,
                     projection_name="spherical", hfov_deg=360)

    # one job writes the stripe, one the %s series, from the same env
    core(["--input", str(tmp_path / "env.exr"), "--output",
          str(tmp_path / "cm.exr"), "--projection", "cubemap",
          "--width", "64", "--twine", "0"])
    core(["--input", str(tmp_path / "env.exr"), "--output",
          str(tmp_path / "cm_%s.exr"), "--projection", "cubemap",
          "--width", "64", "--twine", "0"])

    stripe = imgio.read_image(str(tmp_path / "cm.exr"))
    assert stripe.shape == (6 * 64, 64, 3)
    for i, face in enumerate(FACE_NAMES):
        fp = tmp_path / f"cm_{face}.exr"
        assert fp.exists(), f"missing cube face file {fp}"
        farr = imgio.read_image(str(fp))
        assert farr.shape == (64, 64, 3)
        # the series is the stripe cut into six squares
        np.testing.assert_array_equal(farr, stripe[i * 64:(i + 1) * 64])

    # metadata probe: a %s input is a cubemap facet (full 1:6 stripe)
    from envutil.core.conventions import Projection
    from envutil.runtime.args import parse_args
    args = parse_args(["--input", str(tmp_path / "cm_%s.exr"),
                       "--output", str(tmp_path / "x.exr"),
                       "--projection", "spherical",
                       "--width", "128", "--twine", "0"])
    fct = args.facets[0]
    assert fct.projection == Projection.CUBEMAP
    assert (fct.width, fct.height) == (64, 6 * 64)
    assert fct.hfov == pytest.approx(math.pi / 2)

    # render back to spherical from both load paths: same IR spline,
    # so the outputs must agree exactly
    core(["--input", str(tmp_path / "cm.exr"), "--output",
          str(tmp_path / "back_stripe.exr"), "--projection",
          "spherical", "--width", "128", "--twine", "0"])
    assets.cache.clear()
    core(["--input", str(tmp_path / "cm_%s.exr"), "--output",
          str(tmp_path / "back_series.exr"), "--projection",
          "spherical", "--width", "128", "--twine", "0"])
    back_stripe = imgio.read_image(str(tmp_path / "back_stripe.exr"))
    back_series = imgio.read_image(str(tmp_path / "back_series.exr"))
    np.testing.assert_array_equal(back_series, back_stripe)
    # and the round trip itself must preserve the environment content
    core(["--input", str(tmp_path / "env.exr"), "--output",
          str(tmp_path / "direct.exr"), "--projection", "spherical",
          "--width", "128", "--twine", "0"])
    direct = imgio.read_image(str(tmp_path / "direct.exr"))
    assert psnr(back_stripe, direct) > 35.0


# ---------------------------------------------------------------------------
# camera RAW contract (fake rawpy)
# ---------------------------------------------------------------------------

class _FakeColorSpace:
    raw = 0
    sRGB = 1
    Adobe = 2
    Wide = 3
    ProPhoto = 4
    XYZ = 5
    ACES = 6


class _FakeRawHandle:
    def __init__(self, module, path):
        self._m = module
        self.path = path
        self.sizes = types.SimpleNamespace(width=6, height=4)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def postprocess(self, **kw):
        self._m.captured = kw
        # mid-grey 16-bit frame: 32767/65535 = 0.4999923...
        return np.full((4, 6, 3), 32767, np.uint16)


def _install_fake_rawpy(monkeypatch):
    fake = types.ModuleType("rawpy")
    fake.ColorSpace = _FakeColorSpace
    fake.DemosaicAlgorithm = types.SimpleNamespace(AHD=11, VNG=12)
    fake.captured = None
    fake.imread = lambda path: _FakeRawHandle(fake, path)
    monkeypatch.setitem(sys.modules, "rawpy", fake)
    return fake


def test_raw_default_decode_contract(monkeypatch):
    """Without raw:* keys the decode is scene-linear, camera WB, no
    auto-brightening, 16-bit - the reference's raw defaults through
    OIIO's libraw plugin."""
    fake = _install_fake_rawpy(monkeypatch)
    arr = imgio.read_image("shot.dng")
    assert fake.captured == dict(output_bps=16, use_camera_wb=True,
                                 no_auto_bright=True, gamma=(1.0, 1.0))
    assert arr.shape == (4, 6, 3)
    # linear pass-through: no colour conversion applied
    np.testing.assert_allclose(arr, 32767.0 / 65535.0, atol=1e-7)


def test_raw_colorspace_key_mapping(monkeypatch):
    """raw:ColorSpace drives rawpy's output_color; the sRGB value also
    switches the transfer curve and declares the file sRGB so the
    working-space conversion linearizes it."""
    fake = _install_fake_rawpy(monkeypatch)
    imgio.read_image("shot.cr2", oiio_options=["raw:ColorSpace=ACES"])
    assert fake.captured["output_color"] == _FakeColorSpace.ACES
    assert fake.captured["gamma"] == (1.0, 1.0)

    arr = imgio.read_image("shot.cr2",
                           oiio_options=["raw:ColorSpace=sRGB"])
    assert fake.captured["output_color"] == _FakeColorSpace.sRGB
    assert fake.captured["gamma"] == (2.222, 4.5)
    # declared sRGB -> converted into the scene-linear working space
    want = imgio.srgb_to_linear(np.float32(32767.0 / 65535.0))
    np.testing.assert_allclose(arr, want, atol=1e-6)


def test_raw_auxiliary_keys(monkeypatch):
    """Exposure / auto_bright / user_flip / demosaic keys map onto the
    rawpy postprocess arguments; unknown keys are ignored."""
    fake = _install_fake_rawpy(monkeypatch)
    imgio.read_image("shot.nef", oiio_options=[
        "raw:Exposure=1.5", "raw:auto_bright=1", "raw:user_flip=3",
        "raw:Demosaic=VNG", "raw:HighlightMode=2",
        "raw:use_camera_wb=0", "raw:bogus_key=7"])
    kw = fake.captured
    assert kw["exp_shift"] == 1.5
    assert kw["no_auto_bright"] is False
    assert kw["user_flip"] == 3
    assert kw["demosaic_algorithm"] == 12
    assert kw["highlight_mode"] == 2
    assert kw["use_camera_wb"] is False
    assert "bogus_key" not in kw


def test_raw_metadata_probe(monkeypatch):
    _install_fake_rawpy(monkeypatch)
    meta = imgio.read_image_metadata("shot.arw")
    assert meta == {"width": 6, "height": 4, "nchannels": 3}


def test_raw_missing_rawpy_message(monkeypatch):
    monkeypatch.setitem(sys.modules, "rawpy", None)
    with pytest.raises(IOError, match="rawpy"):
        imgio.read_image("shot.dng")
