"""Built-in colour space tests (io/colour.py): matrices derived from
primaries match the published standards, round trips are exact, and
the imgio hook routes non-sRGB pairs through the built-ins."""

import numpy as np
import pytest

from envutil.io import colour as C
from envutil.io import imgio

RNG = np.random.default_rng(11)


def test_rec709_matrix_matches_bt709_spec():
    """Derived Rec.709->XYZ matrix equals the published BT.709 /
    IEC 61966 values."""
    m = C.rgb_to_xyz_matrix(*C._PRIMARIES["rec709"])
    ref = np.array([[0.4123908, 0.35758434, 0.18048079],
                    [0.21263901, 0.71516868, 0.07219232],
                    [0.01933082, 0.11919478, 0.95053215]])
    np.testing.assert_allclose(m, ref, atol=2e-4)


def test_white_maps_to_white():
    """Equal-energy white survives every gamut pair (white adaptation
    correctness)."""
    spaces = ["scene_linear", "lin_rec2020", "ACEScg", "ACES2065-1",
              "lin_p3d65"]
    w = np.ones((1, 3), np.float32)
    for a in spaces:
        for b in spaces:
            out = C.convert(w, a, b)
            np.testing.assert_allclose(out, w, atol=2e-4,
                                        err_msg=f"{a}->{b}")


@pytest.mark.parametrize("pair", [("scene_linear", "ACEScg"),
                                  ("sRGB", "lin_rec2020"),
                                  ("rec709", "gamma2.2"),
                                  ("ACES2065-1", "lin_p3d65")])
def test_round_trip(pair):
    a, b = pair
    x = RNG.uniform(0.0, 1.0, (64, 3)).astype(np.float32)
    y = C.convert(C.convert(x, a, b), b, a)
    np.testing.assert_allclose(y, x, atol=1e-4)


def test_srgb_transfer_matches_imgio():
    x = RNG.uniform(0.0, 1.0, (32, 3)).astype(np.float32)
    np.testing.assert_allclose(C.convert(x, "sRGB", "scene_linear"),
                               imgio.srgb_to_linear(x), atol=1e-6)


def test_imgio_convert_colour_uses_builtin():
    x = RNG.uniform(0.0, 1.0, (4, 4, 3)).astype(np.float32)
    out = imgio.convert_colour(x, "ACEScg", "scene_linear")
    ref = C.convert(x, "ACEScg", "scene_linear")
    np.testing.assert_allclose(out, ref)
    # alpha passes through
    xa = np.concatenate([x, np.full((4, 4, 1), 0.7, np.float32)], -1)
    outa = imgio.convert_colour(xa, "ACEScg", "scene_linear")
    np.testing.assert_allclose(outa[..., 3], 0.7)
    np.testing.assert_allclose(outa[..., :3], ref)
    # unknown spaces still raise (OCIO absent)
    with pytest.raises(ValueError, match="OCIO"):
        imgio.convert_colour(x, "weird_cam_log", "scene_linear")


def test_acescg_to_rec709_known_value():
    """AP1 pure green is out of the 709 gamut: conversion must land on
    the documented (negative-R) linear value."""
    g = np.array([[0.0, 1.0, 0.0]], np.float32)
    out = C.convert(g, "ACEScg", "lin_rec709")
    # published ACEScg->Rec709 (Bradford D60->D65) middle column
    np.testing.assert_allclose(out[0], [-0.62179, 1.14080, -0.12897],
                               atol=2e-4)


def test_ocio_subset_config(tmp_path, monkeypatch):
    """Built-in OCIO config reader: roles/aliases resolve, matrix +
    exponent-with-linear chains apply, and the inverse direction is
    derived from the forward spec."""
    import textwrap

    import numpy as np

    from envutil.io import imgio, ocio

    cfg = tmp_path / "test.ocio"
    cfg.write_text(textwrap.dedent("""\
        ocio_profile_version: 2
        roles:
          scene_linear: lin
        colorspaces:
          - name: lin
            aliases: [linear, reference]
          - name: srgbish
            aliases: [my_srgb]
            to_scene_reference: !<ExponentWithLinearTransform>
              gamma: [2.4, 2.4, 2.4, 1]
              offset: [0.055, 0.055, 0.055, 0]
          - name: halfscale
            from_scene_reference: !<MatrixTransform>
              matrix: [0.5, 0, 0, 0,
                       0, 0.5, 0, 0,
                       0, 0, 0.5, 0,
                       0, 0, 0, 1]
          - name: wide
            to_scene_reference: !<GroupTransform>
              children:
                - !<ExponentTransform> {value: [2.2, 2.2, 2.2, 1]}
                - !<MatrixTransform>
                  matrix: [2, 0, 0, 0,
                           0, 2, 0, 0,
                           0, 0, 2, 0,
                           0, 0, 0, 1]
        """))
    monkeypatch.setenv("OCIO", str(cfg))
    ocio._CACHE.clear()

    v = np.linspace(0.01, 0.95, 33 * 3,
                    dtype=np.float32).reshape(-1, 1, 3)

    # the monCurve with gamma 2.4 / offset 0.055 IS the sRGB EOTF
    out = imgio.convert_colour(v, "my_srgb", "scene_linear")
    np.testing.assert_allclose(out, imgio.srgb_to_linear(v),
                               atol=2e-5)
    # inverse derived from the same forward spec
    back = imgio.convert_colour(out, "lin", "srgbish")
    np.testing.assert_allclose(back, v, atol=2e-5)

    # matrix space, from_reference given: lin -> halfscale halves
    out = imgio.convert_colour(v, "linear", "halfscale")
    np.testing.assert_allclose(out, v * 0.5, atol=1e-6)
    # and the to_reference direction inverts the matrix
    back = imgio.convert_colour(out, "halfscale", "lin")
    np.testing.assert_allclose(back, v, atol=1e-6)

    # group chain: decode gamma 2.2 then scale x2; srgbish -> wide
    # goes through the reference
    out = imgio.convert_colour(v, "srgbish", "wide")
    ref = (imgio.srgb_to_linear(v) / 2.0) ** (1 / 2.2)
    np.testing.assert_allclose(out, ref, atol=2e-5)

    # unknown name in the config -> None path falls through to the
    # built-in spaces (Rec709 etc.) without raising
    out = imgio.convert_colour(v, "sRGB", "scene_linear")
    np.testing.assert_allclose(out, imgio.srgb_to_linear(v),
                               atol=2e-5)


def test_ocio_file_transform_luts(tmp_path, monkeypatch):
    """FileTransform LUTs: .cube 1D (forward + monotone inverse),
    .cube 3D (trilinear), .spi1d, resolved via search_path."""
    import textwrap

    import numpy as np

    from envutil.io import imgio, ocio

    luts = tmp_path / "luts"
    luts.mkdir()
    # 1D gamma-ish LUT: y = x^2 over [0, 1], 65 knots
    n = 65
    x = np.linspace(0, 1, n)
    (luts / "sq.cube").write_text(
        "LUT_1D_SIZE 65\n"
        + "".join(f"{v:.8f} {v:.8f} {v:.8f}\n" for v in x ** 2))
    # 3D LUT: channel-wise scale (r*0.5, g*0.25, b*1.0), 9^3 lattice
    m = 9
    g = np.linspace(0, 1, m)
    rows = []
    for b in g:
        for gg in g:
            for r in g:  # red fastest
                rows.append(f"{r * 0.5:.8f} {gg * 0.25:.8f} {b:.8f}\n")
    (luts / "scale.cube").write_text(f"LUT_3D_SIZE {m}\n" + "".join(rows))
    # spi1d: y = 2x over [0, 2]
    (luts / "dbl.spi1d").write_text(
        "Version 1\nFrom: 0.0 2.0\nLength: 3\nComponents: 1\n"
        "{\n0.0\n2.0\n4.0\n}\n")

    cfg = tmp_path / "test.ocio"
    cfg.write_text(textwrap.dedent("""\
        ocio_profile_version: 2
        search_path: luts
        roles:
          scene_linear: lin
        colorspaces:
          - name: lin
          - name: squared
            to_scene_reference: !<FileTransform> {src: sq.cube}
          - name: scaled
            from_scene_reference: !<FileTransform> {src: scale.cube, interpolation: tetrahedral}
          - name: doubled
            from_scene_reference: !<FileTransform> {src: dbl.spi1d}
        """))
    monkeypatch.setenv("OCIO", str(cfg))
    ocio._CACHE.clear()

    v = np.linspace(0.05, 0.9, 24, dtype=np.float32).reshape(-1, 1, 3)

    # 1D forward: squared -> lin applies x^2 (exact at this density)
    out = imgio.convert_colour(v, "squared", "scene_linear")
    np.testing.assert_allclose(out, v ** 2, atol=2e-4)
    # 1D inverse (monotone): lin -> squared applies sqrt
    back = imgio.convert_colour(out, "lin", "squared")
    np.testing.assert_allclose(back, v, atol=2e-4)

    # 3D trilinear: lin -> scaled is exact for a linear lattice
    out = imgio.convert_colour(v, "lin", "scaled")
    np.testing.assert_allclose(
        out, v * np.asarray([0.5, 0.25, 1.0], np.float32), atol=1e-5)

    # spi1d with a [0, 2] domain
    out = imgio.convert_colour(v, "lin", "doubled")
    np.testing.assert_allclose(out, v * 2.0, atol=1e-5)


def test_ocio_log_and_cdl_sat(tmp_path, monkeypatch):
    """LogCameraTransform (ARRI LogC3 parameterization),
    LogAffineTransform round trip, CDL saturation."""
    import textwrap

    import numpy as np

    from envutil.io import imgio, ocio

    # ARRI LogC3 EI800 as an OCIO v2 LogCameraTransform (the standard
    # published parameterization)
    cfg = tmp_path / "log.ocio"
    cfg.write_text(textwrap.dedent("""\
        ocio_profile_version: 2
        roles:
          scene_linear: lin
        colorspaces:
          - name: lin
          - name: logc3
            to_scene_reference: !<LogCameraTransform>
              base: 10
              log_side_slope: [0.24719, 0.24719, 0.24719]
              log_side_offset: [0.385537, 0.385537, 0.385537]
              lin_side_slope: [5.555556, 5.555556, 5.555556]
              lin_side_offset: [0.052272, 0.052272, 0.052272]
              lin_side_break: [0.010591, 0.010591, 0.010591]
              direction: inverse
          - name: log2
            to_scene_reference: !<LogAffineTransform>
              base: 2
              log_side_slope: [0.3, 0.3, 0.3]
              log_side_offset: [0.5, 0.5, 0.5]
              direction: inverse
          - name: desat
            from_scene_reference: !<CDLTransform>
              slope: [1, 1, 1]
              offset: [0, 0, 0]
              power: [1, 1, 1]
              sat: 0.5
        """))
    monkeypatch.setenv("OCIO", str(cfg))
    ocio._CACHE.clear()

    v = np.linspace(0.002, 0.9, 30, dtype=np.float32).reshape(-1, 1, 3)

    # LogC3 encode: known reference point - mid grey 0.18 encodes to
    # ~0.391 (ARRI's published LogC3 EI800 value)
    grey = np.full((1, 1, 3), 0.18, np.float32)
    enc = imgio.convert_colour(grey, "lin", "logc3")
    np.testing.assert_allclose(enc, 0.391, atol=0.002)
    # round trip through the break region and above
    enc = imgio.convert_colour(v, "lin", "logc3")
    back = imgio.convert_colour(enc, "logc3", "lin")
    np.testing.assert_allclose(back, v, rtol=2e-4, atol=2e-6)

    # LogAffine round trip
    enc = imgio.convert_colour(v, "lin", "log2")
    back = imgio.convert_colour(enc, "log2", "scene_linear")
    np.testing.assert_allclose(back, v, rtol=2e-4, atol=2e-6)

    # CDL saturation: greys unchanged, chroma halved toward luma
    px = np.asarray([[[0.6, 0.2, 0.4]]], np.float32)
    out = imgio.convert_colour(px, "lin", "desat")
    luma = float((px * np.asarray([0.2126, 0.7152, 0.0722])).sum())
    np.testing.assert_allclose(out, luma + 0.5 * (px - luma),
                               atol=1e-6)
    back = imgio.convert_colour(out, "desat", "lin")
    np.testing.assert_allclose(back, px, atol=1e-6)


@pytest.mark.parametrize("name,enc018", [
    ("slog3", 420.0 / 1023.0),
    ("logc3", 0.391007),
    ("log3g10", 1.0 / 3.0),
    ("vlog", 0.423311),
    ("acescct", 0.4135884),
    ("acescc", 0.4135884),
    ("logc4", 0.2783958),
])
def test_camera_log_grey_anchors(name, enc018):
    """Each camera-log encode maps 18% grey to the vendor-published
    code value (the standard cross-check for these curves)."""
    dec, enc = C._TRANSFERS[name]
    got = float(np.asarray(enc(np.float32(0.18))).ravel()[0])
    assert abs(got - enc018) < 2e-4, (name, got, enc018)


@pytest.mark.parametrize("name", ["acescct", "logc3", "logc4", "slog3",
                                  "log3g10", "vlog", "clog2"])
def test_camera_log_round_trip(name):
    """decode(encode(x)) == x across the break region, negatives, and
    HDR range (ACEScc excluded: it floors negatives per S-2014-003)."""
    dec, enc = C._TRANSFERS[name]
    x = np.linspace(-0.05, 8.0, 2001, dtype=np.float32)
    np.testing.assert_allclose(dec(enc(x)), x, atol=2e-5, rtol=1e-4)


def test_camera_space_conversion():
    """Full camera-space conversions: curve + derived gamut matrix.
    Greys are achromatic in every camera gamut, and AP1->AP0 matches
    the published ACES matrix."""
    grey = np.full((1, 3), 420.0 / 1023.0, np.float32)
    out = C.convert(grey, "slog3", "ACES2065-1")
    np.testing.assert_allclose(out, 0.18, atol=1e-5)
    m = C.conversion_matrix(C.find_space("acescg"),
                            C.find_space("aces"))
    ref = np.array([[0.6954522414, 0.1406786965, 0.1638690622],
                    [0.0447945634, 0.8596711185, 0.0955343182],
                    [-0.0055258826, 0.0040252103, 1.0015006723]])
    np.testing.assert_allclose(m, ref, atol=1e-7)
    # round trip a colour through a camera space
    x = RNG.uniform(0.01, 1.0, (16, 3)).astype(np.float32)
    y = C.convert(C.convert(x, "lin_rec709", "logc4"), "logc4",
                  "lin_rec709")
    np.testing.assert_allclose(y, x, atol=2e-4)


def test_ocio_builtin_transform_styles(tmp_path, monkeypatch):
    """BuiltinTransform: the ACES config registry styles - camera
    *_to_ACES2065-1 (forward + direction inverse), curve-only styles,
    and the CIE-XYZ-D65 display hub."""
    import textwrap

    from envutil.io import imgio, ocio

    cfg = tmp_path / "aceslike.ocio"
    cfg.write_text(textwrap.dedent("""\
        ocio_profile_version: 2
        roles:
          scene_linear: ACES2065-1
        colorspaces:
          - name: ACES2065-1
          - name: ACEScct
            to_scene_reference: !<BuiltinTransform>
              style: ACEScct_to_ACES2065-1
          - name: ACEScg
            from_scene_reference: !<BuiltinTransform>
              style: ACEScg_to_ACES2065-1
              direction: inverse
          - name: slog3_sg3
            to_scene_reference: !<BuiltinTransform>
              style: SONY_SLOG3-SGAMUT3_to_ACES2065-1
          - name: logc4
            to_scene_reference: !<BuiltinTransform>
              style: ARRI_LOGC4_to_ACES2065-1
          - name: acescct_curve
            to_scene_reference: !<BuiltinTransform>
              style: CURVE - ACEScct-LOG_to_LINEAR
          - name: srgb_display
            from_scene_reference: !<GroupTransform>
              children:
                - !<BuiltinTransform> {style: UTILITY - ACES-AP0_to_CIE-XYZ-D65_BFD}
                - !<BuiltinTransform> {style: DISPLAY - CIE-XYZ-D65_to_sRGB}
        """))
    monkeypatch.setenv("OCIO", str(cfg))
    ocio._CACHE.clear()

    grey = np.full((1, 1, 3), 0.4135884, np.float32)
    out = imgio.convert_colour(grey, "ACEScct", "scene_linear")
    np.testing.assert_allclose(out, 0.18, atol=1e-4)
    back = imgio.convert_colour(out, "ACES2065-1", "ACEScct")
    np.testing.assert_allclose(back, grey, atol=1e-5)

    # camera greys land on 0.18 AP0 grey
    for name, cv in (("slog3_sg3", 420.0 / 1023.0),
                     ("logc4", 0.2783958)):
        g = np.full((1, 1, 3), cv, np.float32)
        out = imgio.convert_colour(g, name, "ACES2065-1")
        np.testing.assert_allclose(out, 0.18, atol=2e-4,
                                   err_msg=name)

    # curve-only style has no gamut hop
    out = imgio.convert_colour(grey, "acescct_curve", "scene_linear")
    np.testing.assert_allclose(out, 0.18, atol=1e-4)

    # display hub: AP0 grey through XYZ to the sRGB encode of 0.18
    g = np.full((1, 1, 3), 0.18, np.float32)
    out = imgio.convert_colour(g, "ACES2065-1", "srgb_display")
    np.testing.assert_allclose(out, imgio.linear_to_srgb(g), atol=1e-4)

    # ACEScg (config spells it direction: inverse on from_reference)
    x = RNG.uniform(0.0, 1.0, (8, 1, 3)).astype(np.float32)
    out = imgio.convert_colour(x, "ACEScg", "ACES2065-1")
    np.testing.assert_allclose(out, C.convert(x, "acescg", "aces"),
                               atol=1e-6)

    # unknown style still raises loudly
    cfg2 = tmp_path / "bad.ocio"
    cfg2.write_text(textwrap.dedent("""\
        ocio_profile_version: 2
        roles: {scene_linear: lin}
        colorspaces:
          - name: lin
          - name: adx
            to_scene_reference: !<BuiltinTransform>
              style: ADX10_to_ACES2065-1
        """))
    monkeypatch.setenv("OCIO", str(cfg2))
    ocio._CACHE.clear()
    with pytest.raises(ValueError, match="ADX10"):
        imgio.convert_colour(x, "adx", "scene_linear")


def test_ocio_grading_transforms(tmp_path, monkeypatch):
    """GradingPrimary / GradingRGBCurve / GradingTone through a config:
    identity at defaults, documented control behaviour, and derived
    inverses."""
    import textwrap

    from envutil.io import imgio, ocio

    cfg = tmp_path / "grade.ocio"
    cfg.write_text(textwrap.dedent("""\
        ocio_profile_version: 2
        roles:
          scene_linear: lin
        colorspaces:
          - name: lin
          - name: exposed
            from_scene_reference: !<GradingPrimaryTransform>
              style: linear
              exposure: {rgb: [0, 0, 0], master: 1}
          - name: graded
            from_scene_reference: !<GradingPrimaryTransform>
              style: log
              contrast: {rgb: [1.1, 1.0, 0.95], master: 1.0}
              saturation: 0.8
          - name: curved
            from_scene_reference: !<GradingRGBCurveTransform>
              style: log
              master: {control_points: [0, 0, 0.5, 0.6, 1, 1]}
          - name: toned
            from_scene_reference: !<GradingToneTransform>
              style: log
              whites: {rgb: [1, 1, 1], master: 1.4, start: 0.5, width: 0.5}
        """))
    monkeypatch.setenv("OCIO", str(cfg))
    ocio._CACHE.clear()

    v = RNG.uniform(0.01, 1.0, (32, 1, 3)).astype(np.float32)

    # +1 stop
    out = imgio.convert_colour(v, "lin", "exposed")
    np.testing.assert_allclose(out, v * 2.0, rtol=1e-6)
    back = imgio.convert_colour(out, "exposed", "lin")
    np.testing.assert_allclose(back, v, rtol=1e-5)

    # log-style grade round-trips through the derived inverse
    out = imgio.convert_colour(v, "lin", "graded")
    back = imgio.convert_colour(out, "graded", "scene_linear")
    np.testing.assert_allclose(back, v, rtol=1e-3, atol=1e-4)

    # curve hits its control point and inverts
    g = np.full((1, 1, 3), 0.5, np.float32)
    out = imgio.convert_colour(g, "lin", "curved")
    np.testing.assert_allclose(out, 0.6, atol=1e-6)
    back = imgio.convert_colour(out, "curved", "lin")
    np.testing.assert_allclose(back, g, atol=2e-3)

    # tone: whites zone lifts highlights, leaves blacks pinned
    hi = np.full((1, 1, 3), 0.9, np.float32)
    lo = np.full((1, 1, 3), 0.05, np.float32)
    out_hi = imgio.convert_colour(hi, "lin", "toned")
    out_lo = imgio.convert_colour(lo, "lin", "toned")
    assert float(out_hi.mean()) > 0.9 + 1e-3
    np.testing.assert_allclose(out_lo, lo, atol=1e-5)
    back = imgio.convert_colour(out_hi, "toned", "lin")
    np.testing.assert_allclose(back, hi, atol=5e-3)


def test_ocio_inverse_lut3d(tmp_path, monkeypatch):
    """Inverse Lut3D: coarse-seed + Newton numeric inverse recovers
    the input of a smooth invertible LUT to ~1e-3."""
    import textwrap

    from envutil.io import imgio, ocio

    m = 17
    g = np.linspace(0, 1, m)
    rows = []
    for b in g:
        for gg in g:
            for r in g:  # red fastest
                rows.append(f"{r ** 1.8:.8f} {gg ** 2.2:.8f} "
                            f"{b ** 1.5:.8f}\n")
    luts = tmp_path / "luts"
    luts.mkdir()
    (luts / "pow.cube").write_text(f"LUT_3D_SIZE {m}\n" + "".join(rows))
    cfg = tmp_path / "test.ocio"
    cfg.write_text(textwrap.dedent("""\
        ocio_profile_version: 2
        search_path: luts
        roles: {scene_linear: lin}
        colorspaces:
          - name: lin
          - name: powed
            from_scene_reference: !<FileTransform> {src: pow.cube}
        """))
    monkeypatch.setenv("OCIO", str(cfg))
    ocio._CACHE.clear()

    v = RNG.uniform(0.05, 0.95, (16, 1, 3)).astype(np.float32)
    enc = imgio.convert_colour(v, "lin", "powed")
    back = imgio.convert_colour(enc, "powed", "scene_linear")
    np.testing.assert_allclose(back, v, atol=2e-3)


def test_aces_output_transform(tmp_path, monkeypatch):
    """ACES SDR output transform: published tonescale knots are hit
    exactly, 18% grey lands at the canonical ~0.10 display-linear Y
    with D65 chromaticity, exposure stays monotone, and the builtin
    style composes with the display encode in a config."""
    import textwrap

    from envutil.io import aces, imgio, ocio

    # tonescale anchors (Tonescales.ctl knot points)
    np.testing.assert_allclose(aces.rrc_tonescale(0.18), 4.8,
                               rtol=1e-9)
    np.testing.assert_allclose(aces.rrc_tonescale(0.18 * 2.0 ** -15),
                               1e-4, rtol=1e-9)
    np.testing.assert_allclose(aces.rrc_tonescale(0.18 * 2.0 ** 18),
                               1e4, rtol=1e-9)
    mid = aces.rrc_tonescale(0.18)
    np.testing.assert_allclose(aces.odt48_tonescale(mid), 4.8,
                               rtol=1e-9)

    grey = np.full((1, 3), 0.18)
    xyz = aces.output_transform_sdr(grey, "dim")
    y = float(xyz[0, 1])
    assert 0.095 < y < 0.112, y
    s = float(xyz.sum())
    np.testing.assert_allclose([xyz[0, 0] / s, xyz[0, 1] / s],
                               [0.3127, 0.3290], atol=2e-3)

    ex = np.stack([np.full(3, 0.18 * 2.0 ** k)
                   for k in np.linspace(-8, 8, 33)])
    ys = aces.output_transform_sdr(ex, "dim")[:, 1]
    assert np.all(np.diff(ys) >= -1e-7)
    assert ys[-1] > 0.99 and ys[0] < 1e-4

    cfg = tmp_path / "view.ocio"
    cfg.write_text(textwrap.dedent("""\
        ocio_profile_version: 2
        roles: {scene_linear: ACES2065-1}
        colorspaces:
          - name: ACES2065-1
          - name: sRGB - Display (ACES)
            aliases: [srgb_view]
            from_scene_reference: !<GroupTransform>
              children:
                - !<BuiltinTransform> {style: ACES-OUTPUT - ACES2065-1_to_CIE-XYZ-D65 - SDR-VIDEO_1.0}
                - !<BuiltinTransform> {style: DISPLAY - CIE-XYZ-D65_to_sRGB}
        """))
    monkeypatch.setenv("OCIO", str(cfg))
    ocio._CACHE.clear()
    out = imgio.convert_colour(np.full((1, 1, 3), 0.18, np.float32),
                               "scene_linear", "srgb_view")
    # the canonical ACES look: mid grey displays near 0.35 sRGB
    assert 0.32 < float(out[..., 1].ravel()[0]) < 0.38, out
    # inverse direction refuses loudly
    with pytest.raises(ValueError, match="forward only"):
        imgio.convert_colour(out, "srgb_view", "scene_linear")


def test_ocio_pq_hlg_display_styles():
    """HDR display encodes: ST 2084 (PQ) and BT.2100 HLG hit the
    published anchor points and round-trip through the display hub."""
    from envutil.io import ocio

    # PQ: 100 nits (display-linear 1.0) encodes to ~0.5081; peak is 1
    np.testing.assert_allclose(float(ocio._pq_encode(1.0)), 0.5080784,
                               atol=1e-6)
    np.testing.assert_allclose(float(ocio._pq_encode(100.0)), 1.0,
                               atol=1e-9)
    # HLG: the 1/12 breakpoint encodes to exactly 0.5, peak to 1
    np.testing.assert_allclose(float(ocio._hlg_encode(1.0 / 12.0)),
                               0.5, atol=1e-9)
    np.testing.assert_allclose(float(ocio._hlg_encode(1.0)), 1.0,
                               atol=1e-7)

    rgb = RNG.uniform(0.02, 0.9, (16, 3)).astype(np.float32)
    m = C.rgb_to_xyz_matrix(*C._PRIMARIES["rec2020"]).astype(np.float32)
    xyz = rgb @ m.T
    for style in ("DISPLAY - CIE-XYZ-D65_to_REC.2100-PQ",
                  "DISPLAY - CIE-XYZ-D65_to_REC.2100-HLG",
                  "DISPLAY - CIE-XYZ-D65_to_ST2084-P3-D65"):
        f = ocio._builtin_fn(style, False, "t")
        g = ocio._builtin_fn(style, True, "t")
        out = f(xyz)
        if "P3" not in style:
            np.testing.assert_allclose(g(out), xyz, rtol=2e-4,
                                       atol=1e-5, err_msg=style)


def test_aces_hdr_output_transforms(tmp_path, monkeypatch):
    """SSTS-based ACES 1.1 HDR Output Transforms: anchor points,
    monotonicity, the independent SDR-parameter agreement anchor, and
    the OCIO builtin-style integration (HDR-VIDEO PQ view)."""
    import textwrap

    from envutil.io import aces, imgio, ocio

    # SSTS anchors: the curve must hit its min/max luminances exactly
    # and map scene 0.18 to the requested mid luminance (expShift)
    for (y_min, y_mid, y_max) in ((0.0001, 15.0, 1000.0),
                                  (0.0001, 15.0, 2000.0),
                                  (0.0001, 15.0, 4000.0),
                                  (0.0001, 7.2, 108.0)):
        p = aces.SstsParams(y_min, y_mid, y_max)
        np.testing.assert_allclose(float(p(0.18)), y_mid, rtol=1e-6)
        np.testing.assert_allclose(float(p(1e-10)), y_min, rtol=1e-6)
        np.testing.assert_allclose(float(p(1e8)), y_max, rtol=1e-6)
        xs = np.logspace(-6.0, 4.0, 4000)
        ys = np.asarray(p(xs))
        assert (np.diff(ys) >= -1e-9).all(), (y_min, y_mid, y_max)

    # independent anchor: at the SDR parameters the SSTS was designed
    # to stand in for the legacy RRT+ODT composite tone scale - they
    # must track within ~10% over the SDR stop range (the SSTS is a
    # 3+3-segment simplification of the 4+7-segment c5/c9 pair)
    x = 0.18 * 2.0 ** np.linspace(-6.5, 6.5, 400)
    legacy = aces.odt48_tonescale(aces.rrc_tonescale(x))
    sdr = aces.SstsParams(0.02, 4.8, 48.0)(x)
    assert np.abs(np.log10(np.asarray(sdr) / legacy)).max() < 0.05

    # neutral grey passes the sweeteners untouched, so the 1000-nit
    # transform puts 18% grey at exactly 15 cd/m2 (XYZ hub: 1.0 ==
    # 100 cd/m2), at the D65 white point
    grey = np.full((1, 3), 0.18)
    xyz = aces.output_transform_hdr(grey, 0.0001, 15.0, 1000.0)
    np.testing.assert_allclose(float(xyz[0, 1]) * 100.0, 15.0,
                               rtol=1e-5)
    s = float(xyz.sum())
    np.testing.assert_allclose([xyz[0, 0] / s, xyz[0, 1] / s],
                               [0.3127, 0.3290], atol=2e-3)
    # highlights saturate toward the peak luminance
    hi = aces.output_transform_hdr(np.full((1, 3), 1e4),
                                   0.0001, 15.0, 1000.0)
    assert float(hi[0, 1]) * 100.0 > 990.0

    # OCIO builtin styles: an HDR-VIDEO PQ display view; PQ(15 nits)
    # is the expected neutral signal level
    cfg = tmp_path / "hdr.ocio"
    cfg.write_text(textwrap.dedent("""\
        ocio_profile_version: 2
        roles: {scene_linear: ACES2065-1}
        colorspaces:
          - name: ACES2065-1
          - name: Rec.2100-PQ - Display (ACES 1000 nit)
            aliases: [pq_view]
            from_scene_reference: !<GroupTransform>
              children:
                - !<BuiltinTransform> {style: ACES-OUTPUT - ACES2065-1_to_CIE-XYZ-D65 - HDR-VIDEO-1000nit-15nit-Rec2020lim_1.1}
                - !<BuiltinTransform> {style: DISPLAY - CIE-XYZ-D65_to_REC.2100-PQ}
          - name: P3 PQ (ACES 108 nit cinema)
            aliases: [pq_cinema]
            from_scene_reference: !<GroupTransform>
              children:
                - !<BuiltinTransform> {style: ACES-OUTPUT - ACES2065-1_to_CIE-XYZ-D65 - HDR-CINEMA-108nit-7.2nit-P3lim_1.1}
                - !<BuiltinTransform> {style: DISPLAY - CIE-XYZ-D65_to_ST2084-P3-D65}
        """))
    monkeypatch.setenv("OCIO", str(cfg))
    ocio._CACHE.clear()

    g = np.full((1, 1, 3), 0.18, np.float32)
    out = imgio.convert_colour(g, "ACES2065-1", "pq_view")
    want = float(ocio._pq_encode(np.float32(0.15)))
    np.testing.assert_allclose(out[..., 1], want, atol=5e-3)
    outc = imgio.convert_colour(g, "ACES2065-1", "pq_cinema")
    wantc = float(ocio._pq_encode(np.float32(0.072)))
    np.testing.assert_allclose(outc[..., 1], wantc, atol=5e-3)

    # forward only: inverting the tone map raises loudly
    with pytest.raises(ValueError, match="forward only"):
        imgio.convert_colour(g, "pq_view", "ACES2065-1")
