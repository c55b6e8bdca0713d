"""PTO parser and argument-system tests (no jax compute)."""

import math
import pathlib
import textwrap

import pytest

from envutil.core.conventions import Projection
from envutil.io import pto

PTO_SAMPLE = textwrap.dedent("""\
    # hugin project file
    p f2 w4096 h2048 v360 E0.5 S100,3996,50,1998 n"TIFF_m"
    m g1 i0

    i w800 h600 f0 v55 y10.5 p-2 r0.25 a0.01 b-0.02 c0.005 d1.5 e-2.5 g0.1 t0.2 TrX0.1 TrY0 TrZ0.3 Tpy5 Tpp-3 Eev12 n"img0.tif"
    i w800 h600 f0 v=0 y-10 p0 r0 n"img1.tif"
    i w1024 h768 f3 v180 y0 p90 r0 S12,1000,10,760 n"fish.tif"

    v v1
    v y1

    c n0 N1 x10.2 y20.3 X400.5 Y300.25 t0
    k i1 t0 p"10 10 100 10 100 100 10 100"
    """)


def test_parse_groups(tmp_path):
    f = tmp_path / "test.pto"
    f.write_text(PTO_SAMPLE)
    p = pto.PtoParser()
    p.read(str(f))
    assert len(p.lines("i")) == 3
    assert len(p.lines("p")) == 1
    assert len(p.lines("c")) == 1
    assert len(p.lines("k")) == 1


def test_field_values(tmp_path):
    f = tmp_path / "t.pto"
    f.write_text(PTO_SAMPLE)
    p = pto.PtoParser()
    p.read(str(f))
    i0 = p.lines("i")[0]
    assert i0.get("w") == "800"
    assert i0.get("y") == "10.5"
    assert i0.get("n") == '"img0.tif"'
    assert pto.unquote(i0.get("n")) == "img0.tif"
    assert i0.get("TrZ") == "0.3"
    assert i0.get("Tpy") == "5"


def test_backreference(tmp_path):
    # v=0 in the second i-line resolves against the first i-line
    f = tmp_path / "t.pto"
    f.write_text(PTO_SAMPLE)
    p = pto.PtoParser()
    p.read(str(f))
    i1 = p.lines("i")[1]
    assert i1.get("v") == "55"


def test_p_line_crop():
    assert pto.parse_crop("100,3996,50,1998") == (100, 3996, 50, 1998)
    assert pto.parse_crop("") is None


def test_mask_vertices():
    vx, vy = pto.parse_mask_vertices('"10 10 100 10 100 100 10 100"')
    assert vx == [10.0, 100.0, 100.0, 10.0]
    assert vy == [10.0, 10.0, 100.0, 100.0]


def test_addenda():
    p = pto.PtoParser()
    p.read("", ["i w10 h10 f0 v50 n\"x.tif\"", "p f2 w100 h50 v360"])
    assert len(p.lines("i")) == 1
    assert len(p.lines("p")) == 1


def _write_fixture_image(path, w=64, h=48):
    import numpy as np

    from envutil.io import imgio
    img = np.zeros((h, w, 3), dtype=np.float32)
    img[..., 0] = 0.5
    imgio.save_image(str(path), img)


def test_args_from_pto(tmp_path):
    from envutil.runtime.args import parse_args
    _write_fixture_image(tmp_path / "img0.exr")
    _write_fixture_image(tmp_path / "img1.exr")
    ptof = tmp_path / "j.pto"
    ptof.write_text(textwrap.dedent("""\
        p f2 w512 h256 v360 Eev1
        i w64 h48 f0 v55 y10 p-2 r0.25 a0.01 b0 c0 d1.5 e-2.5 Eev0.5 n"{d}/img0.exr"
        i w64 h48 f0 v45 y-10 p0 r0 TrX0.25 TrZ0.125 Eev1.5 n"{d}/img1.exr"
        """).format(d=tmp_path))
    args = parse_args(["--pto", str(ptof), "--output", "/tmp/out.exr"])
    assert args.nfacets == 2
    # p-line geometry taken over
    assert args.projection == Projection.SPHERICAL
    assert args.width == 512 and args.height == 256
    assert abs(args.hfov - 2 * math.pi) < 1e-9
    f0, f1 = args.facets
    assert abs(f0.yaw - math.radians(10)) < 1e-12
    assert f0.has_lcp and f0.has_shift
    # d/e (pixels) converted to model units by process_geometry
    assert f0.h != 1.5
    # TrZ sign flip (envutil_main.cc:789)
    assert f1.tr_z == -0.125
    assert f1.has_translation
    # Eev -> brighten: p-line Eev 1 is the target
    assert abs(f0.brighten - 2.0 ** (0.5 - 1.0)) < 1e-12
    assert abs(f1.brighten - 2.0 ** (1.5 - 1.0)) < 1e-12


def test_args_facet_cli(tmp_path):
    from envutil.runtime.args import parse_args
    _write_fixture_image(tmp_path / "env.exr")
    args = parse_args(["--facet", str(tmp_path / "env.exr"), "spherical",
                       "360", "15", "0", "0",
                       "--output", "o.exr", "--projection", "rectilinear",
                       "--hfov", "90", "--width", "200"])
    assert args.nfacets == 1
    assert args.solo == 0  # single facet -> solo
    f = args.facets[0]
    assert f.projection == Projection.SPHERICAL
    assert abs(f.yaw - math.radians(15)) < 1e-12
    assert args.width == 200 and args.height == 200


def test_twine_setup_auto(tmp_path):
    from envutil.runtime.args import parse_args
    _write_fixture_image(tmp_path / "env.exr", w=512, h=256)
    # downscale: 512-wide 360deg source to 64-wide 90deg rectilinear
    args = parse_args(["--facet", str(tmp_path / "env.exr"), "spherical",
                       "360", "0", "0", "0", "--output", "o.exr",
                       "--width", "64", "--hfov", "90"])
    args.twine_setup()
    assert args.twine > 1          # automatic anti-aliasing kicks in
    assert len(args.twine_spread) == args.twine * args.twine
    w = sum(c[2] for c in args.twine_spread)
    assert abs(w - 1.0) < 1e-6


def test_twf_file(tmp_path):
    from envutil.models.twining import read_twf_file
    f = tmp_path / "k.twf"
    f.write_text("0 0 2\n1 0 1\n0 1 1\n")
    taps = read_twf_file(str(f), twine_width=2.0, normalize=True)
    assert len(taps) == 3
    assert taps[1][0] == 2.0     # scaled by twine_width
    assert abs(sum(t[2] for t in taps) - 1.0) < 1e-12
