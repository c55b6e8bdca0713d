"""Out-of-core tile/scanline store tests (the zimt/tiles.h +
zimt/scanlines.h analog): on-demand per-tile files, ref-counted bounded
residency, windowed read/write round trips, native EXR scanline
streaming, and rendering straight into a store."""

import math

import numpy as np
import pytest

from envutil.io import imgio
from envutil.io.tiles import (LineStore, TileStore, exr_line_reader,
                              exr_line_writer, render_to_store)


def ramp(h, w, c=3):
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    return np.stack([x / w, y / h, (x + y) % 7.0], -1)[..., :c]


def test_tile_store_window_round_trip(tmp_path):
    img = ramp(300, 500)
    with TileStore(tmp_path / "ts", "w", shape=img.shape,
                   tile_shape=(128, 128)) as st:
        st.write_window(img, 0, 0)
    # reopen read-only, windows cross tile boundaries + ragged edges
    st = TileStore(tmp_path / "ts", "r")
    assert st.ntiles == (3, 4)
    np.testing.assert_array_equal(st.read_window(0, 300, 0, 500), img)
    np.testing.assert_array_equal(st.read_window(100, 260, 120, 130),
                                  img[100:260, 120:130])
    with pytest.raises(PermissionError):
        st.write_window(img[:10, :10], 0, 0)


def test_tile_store_eviction_write_through(tmp_path):
    img = ramp(512, 512)
    st = TileStore(tmp_path / "ts", "w", shape=img.shape,
                   tile_shape=(64, 64), max_resident=2)
    # piecewise writes force evictions (64 tiles, budget 2)
    for y in range(0, 512, 100):
        st.write_window(img[y:y + 100], y, 0)
    assert len(st._resident) <= 2 + 1
    st.close()
    assert len(list((tmp_path / "ts").glob("tile_*.npy"))) == 64
    got = TileStore(tmp_path / "ts", "r").read_window(0, 512, 0, 512)
    np.testing.assert_array_equal(got, img)


def test_tile_store_absent_tiles_read_zero(tmp_path):
    st = TileStore(tmp_path / "ts", "w", shape=(100, 100, 1),
                   tile_shape=(50, 50))
    np.testing.assert_array_equal(st.read_window(0, 100, 0, 100),
                                  np.zeros((100, 100, 1), np.float32))


def test_tile_refcount(tmp_path):
    st = TileStore(tmp_path / "ts", "w", shape=(64, 64, 1),
                   tile_shape=(32, 32), max_resident=0)
    t = st.get(0, 0, for_write=True)
    t.data[:] = 5.0
    t2 = st.get(0, 0)
    assert t2 is t and t.nusers == 2
    st.release(t)
    assert (0, 0) in st._resident  # still held
    st.release(t2)
    assert (0, 0) not in st._resident  # evicted write-through
    assert st.tile_path(0, 0).exists()


def test_line_store_callbacks():
    img = ramp(20, 30)
    seen = {}
    ls = LineStore(30, 20, 3, load_fn=lambda y: img[y],
                   store_fn=lambda y, l: seen.__setitem__(y, l.copy()))
    np.testing.assert_array_equal(ls.read_window(3, 7, 5, 25),
                                  img[3:7, 5:25])
    ls.write_window(img[2:5], 2, 0)
    assert sorted(seen) == [2, 3, 4]
    np.testing.assert_array_equal(seen[3], img[3])


def test_exr_scanline_stream_round_trip(tmp_path):
    img = ramp(64, 96)
    path = str(tmp_path / "stream.exr")
    wr = exr_line_writer(path, 96, 64, 3, projection_name="spherical",
                         hfov_deg=360.0)
    for y in range(0, 64, 16):
        wr.write(img[y:y + 16])
    wr.close()

    # whole-file reader sees identical pixels + metadata
    full = imgio.read_image(path)
    np.testing.assert_allclose(full, img, atol=0)
    meta = imgio.read_image_metadata(path)
    assert meta["Projection"] == "spherical"
    assert meta["Hfov"] == 360.0
    # the probe is header-only (envio_read_exr_header): it must report
    # size/channels without decoding pixels
    assert (meta["width"], meta["height"], meta["nchannels"]) == (96, 64, 3)

    # scanline reader in arbitrary (non-sequential) order
    rd = exr_line_reader(path)
    assert (rd.width, rd.height, rd.nchannels) == (96, 64, 3)
    np.testing.assert_array_equal(rd.read(40, 8), img[40:48])
    np.testing.assert_array_equal(rd.read(0, 1), img[0:1])
    ls = rd.line_store()
    np.testing.assert_array_equal(ls.read_window(10, 12, 0, 96),
                                  img[10:12])
    rd.close()


def test_exr_writer_rejects_short_close(tmp_path):
    wr = exr_line_writer(str(tmp_path / "short.exr"), 8, 8, 3)
    wr.write(ramp(4, 8))
    with pytest.raises(IOError):
        wr.close()


def test_render_to_store_matches_render_frame(tmp_path):
    """Strip-rendering into a TileStore equals the in-RAM frame."""
    from envutil.core.conventions import Projection
    from envutil.core.facet import Facet
    from envutil.core.metrics import get_extent, get_step
    from envutil.models import environment as E
    from envutil.runtime.args import Args
    from envutil.runtime.render import build_plan, render_frame

    w, h = 128, 64
    img = ramp(h, w)
    fct = Facet(facet_no=0, nchannels=3)
    fct.set_geometry(Projection.SPHERICAL, w, h, 2 * math.pi)
    fct.step = get_step(Projection.SPHERICAL, w, h, 2 * math.pi)
    fct.process_geometry()
    src = E.make_mount_source(fct, img, 1, 1)

    args = Args()
    args.projection = Projection.RECTILINEAR
    args.width, args.height = 96, 80
    args.hfov = math.pi / 2
    args.extent = get_extent(args.projection, 96, 80, args.hfov)
    args.step = (args.extent.x1 - args.extent.x0) / 96
    args.spline_degree = args.prefilter_degree = 1
    args.nchannels = 3
    args.facets = [fct]
    plan = build_plan(args, [fct])

    ref = render_frame(plan, [src])
    with TileStore(tmp_path / "out", "w", shape=(80, 96, 3),
                   tile_shape=(32, 32), max_resident=4) as st:
        render_to_store(plan, [src], st, strip_rows=24)
    got = TileStore(tmp_path / "out", "r").read_window(0, 80, 0, 96)
    np.testing.assert_allclose(got, ref, atol=1e-5)

    # and straight into a scanline EXR via a LineStore
    path = str(tmp_path / "out.exr")
    wr = exr_line_writer(path, 96, 80, 3)
    render_to_store(plan, [src], wr.line_store(), strip_rows=80)
    wr.close()
    np.testing.assert_allclose(imgio.read_image(path), ref, atol=1e-5)


def test_oiio_option_parsing_and_raw_gate(tmp_path):
    # --oiio dialect: key[@TYPE]=value / bare key (envutil_basic.h:843-905)
    from envutil.io.imgio import parse_oiio_options, read_image
    assert parse_oiio_options(
        ["raw:ColorSpace=linear", "oiio:UnassociatedAlpha@int=1", "flag"]
    ) == [("raw:ColorSpace", "", "linear"),
          ("oiio:UnassociatedAlpha", "int", "1"),
          ("flag", "", "")]
    # RAW input without rawpy installed must fail with a clear message,
    # not an AttributeError deep in a decoder
    raw = tmp_path / "shot.cr2"
    raw.write_bytes(b"II*\x00 not really a raw file")
    try:
        import rawpy  # noqa: F401
        has_rawpy = True
    except ImportError:
        has_rawpy = False
    if not has_rawpy:
        with pytest.raises(IOError, match="rawpy"):
            read_image(str(raw))
