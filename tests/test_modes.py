"""End-to-end job-mode tests through the CLI core: PTO multi-facet
stitching, --single/--split re-creation, --mask_for, --solo, streaming
asset reuse. Small rasters, CPU."""

import math
import textwrap

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
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 10 * math.log10(1.0 / mse) if mse > 0 else 999.0


def test_pto_two_facet_voronoi(tmp_path):
    env = synthetic_equirect()
    imgio.save_image(str(tmp_path / "env.exr"), env,
                     projection_name="spherical", hfov_deg=360)
    # two rectilinear facets extracted from the environment...
    for i, yaw in enumerate((-20.0, 20.0)):
        core(["--input", str(tmp_path / "env.exr"), "--output",
              str(tmp_path / f"f{i}.exr"), "--projection", "rectilinear",
              "--hfov", "60", "--width", "96", "--height", "96",
              "--yaw", str(yaw), "--twine", "0"])
    # ...then stitched back into a small pano via a PTO script
    ptof = tmp_path / "stitch.pto"
    ptof.write_text(textwrap.dedent(f"""\
        p f2 w192 h96 v100
        i w96 h96 f0 v60 y-20 p0 r0 n"{tmp_path}/f0.exr"
        i w96 h96 f0 v60 y20 p0 r0 n"{tmp_path}/f1.exr"
        """))
    core(["--pto", str(ptof), "--output", str(tmp_path / "pano.exr"),
          "--twine", "0"])
    pano = imgio.read_image(str(tmp_path / "pano.exr"))
    assert pano.shape == (96, 192, 3)
    # compare against a direct render of the same view from the env
    core(["--input", str(tmp_path / "env.exr"), "--output",
          str(tmp_path / "direct.exr"), "--projection", "spherical",
          "--hfov", "100", "--width", "192", "--height", "96",
          "--twine", "0"])
    direct = imgio.read_image(str(tmp_path / "direct.exr"))
    # compare the central region covered by both facets
    p = psnr(pano[20:-20, 40:-40], direct[20:-20, 40:-40])
    assert p > 30.0, f"stitch vs direct PSNR {p:.1f} dB"


def test_single_recreation_roundtrip(tmp_path):
    # render a facet from the env, stitch-earth it back with --single:
    # re-created facet must match the original extraction
    env = synthetic_equirect()
    imgio.save_image(str(tmp_path / "env.exr"), env,
                     projection_name="spherical", hfov_deg=360)
    core(["--input", str(tmp_path / "env.exr"), "--output",
          str(tmp_path / "view.exr"), "--projection", "rectilinear",
          "--hfov", "70", "--width", "96", "--height", "96",
          "--yaw", "15", "--pitch", "5", "--twine", "0"])
    ptof = tmp_path / "one.pto"
    ptof.write_text(textwrap.dedent(f"""\
        i w256 h128 f4 v360 y0 p0 r0 n"{tmp_path}/env.exr"
        i w96 h96 f0 v70 y15 p5 r0 n"{tmp_path}/view.exr"
        """))
    core(["--pto", str(ptof), "--output", str(tmp_path / "single.exr"),
          "--single", "1", "--solo", "0", "--twine", "0"])
    re_created = imgio.read_image(str(tmp_path / "single.exr"))
    original = imgio.read_image(str(tmp_path / "view.exr"))
    p = psnr(re_created, original)
    assert re_created.shape == original.shape
    assert p > 35.0, f"--single re-creation PSNR {p:.1f} dB"


def test_split_mode(tmp_path):
    env = synthetic_equirect()
    imgio.save_image(str(tmp_path / "env.exr"), env,
                     projection_name="spherical", hfov_deg=360)
    # facet sizes come from the image files (get_image_metrics), so
    # facet 1 needs a real 64x64 file
    small = np.full((64, 64, 3), 0.5, np.float32)
    imgio.save_image(str(tmp_path / "small.exr"), small)
    ptof = tmp_path / "two.pto"
    ptof.write_text(textwrap.dedent(f"""\
        i w256 h128 f4 v360 y0 p0 r0 n"{tmp_path}/env.exr"
        i w64 h64 f0 v60 y30 p0 r0 n"{tmp_path}/small.exr"
        """))
    core(["--pto", str(ptof), "--split", str(tmp_path / "part_%d.exr"),
          "--solo", "0", "--twine", "0"])
    # facet 0 is the solo facet -> skipped; facet 1 re-created
    assert not (tmp_path / "part_0.exr").exists()
    part1 = imgio.read_image(str(tmp_path / "part_1.exr"))
    assert part1.shape == (64, 64, 3)
    assert np.isfinite(part1).all() and part1.std() > 0.01


def test_mask_for(tmp_path):
    env = synthetic_equirect()
    imgio.save_image(str(tmp_path / "env.exr"), env,
                     projection_name="spherical", hfov_deg=360)
    view = np.full((64, 64, 3), 0.25, np.float32)
    imgio.save_image(str(tmp_path / "v.exr"), view)
    ptof = tmp_path / "m.pto"
    ptof.write_text(textwrap.dedent(f"""\
        p f2 w128 h64 v360
        i w256 h128 f4 v360 y0 p0 r0 n"{tmp_path}/env.exr"
        i w64 h64 f0 v60 y0 p0 r0 n"{tmp_path}/v.exr"
        """))
    core(["--pto", str(ptof), "--output", str(tmp_path / "mask.exr"),
          "--mask_for", "1", "--nchannels", "1", "--twine", "0"])
    mask = imgio.read_image(str(tmp_path / "mask.exr"))
    # white where facet 1 wins (center front), black elsewhere
    assert mask[32, 64] > 0.9
    assert mask[32, 5] < 0.1
    assert mask[5, 64] < 0.1


def test_streaming_asset_reuse(tmp_path, capsys):
    env = synthetic_equirect()
    imgio.save_image(str(tmp_path / "env.exr"), env,
                     projection_name="spherical", hfov_deg=360)
    base = ["--input", str(tmp_path / "env.exr"), "--projection",
            "rectilinear", "--hfov", "60", "--width", "64", "--twine",
            "0", "-v"]
    core(base + ["--output", str(tmp_path / "a.exr"), "--yaw", "0"])
    out1 = capsys.readouterr().out
    assert "loaded" in out1
    core(base + ["--output", str(tmp_path / "b.exr"), "--yaw", "10"])
    out2 = capsys.readouterr().out
    assert "already present in RAM" in out2


def test_cp_statistics_brightness_ratio(tmp_path, capsys):
    """-v with PTO c-lines prints the CP intensity matrix; for a x2
    exposure pair the pooled ratio must come out ~2 (the reference's
    experimental CP block, envutil_payload.cc:1950-2026)."""
    base = np.full((64, 64, 3), 0.25, np.float32)
    base += 0.1 * np.random.default_rng(0).random((64, 64, 3),
                                                  np.float32)
    imgio.save_image(str(tmp_path / "a.exr"), base,
                     projection_name="rectilinear", hfov_deg=60)
    imgio.save_image(str(tmp_path / "b.exr"), 2.0 * base,
                     projection_name="rectilinear", hfov_deg=60)
    ptof = tmp_path / "cp.pto"
    ptof.write_text(textwrap.dedent(f"""\
        p f0 w64 h64 v60
        i w64 h64 f0 v60 y0 p0 r0 n"{tmp_path}/a.exr"
        i w64 h64 f0 v60 y0 p0 r0 n"{tmp_path}/b.exr"
        c n0 N1 x20.0 y30.0 X20.0 Y30.0 t0
        c n0 N1 x40.5 y12.25 X40.5 Y12.25 t0
        """))
    core(["--pto", str(ptof), "--output", str(tmp_path / "out.exr"),
          "--twine", "0", "--synopsis", "hdr_merge", "-v"])
    out = capsys.readouterr().out
    assert "CP intensity check:" in out
    ratio_line = [l for l in out.splitlines() if l.startswith("1:0 ")]
    assert ratio_line, out
    ratio = float(ratio_line[0].split()[1])
    assert abs(ratio - 2.0) < 0.05, ratio


def test_coeff_cache_resume(tmp_path):
    """--coeff_cache persists prefiltered coefficients; a fresh
    process state (cleared RAM cache) restores them from disk and the
    render is bit-identical. Touching the source invalidates."""
    env = synthetic_equirect(128, 64)
    imgio.save_image(str(tmp_path / "env.exr"), env,
                     projection_name="spherical", hfov_deg=360)
    cdir = tmp_path / "ccache"
    argv = ["--input", str(tmp_path / "env.exr"), "--projection",
            "rectilinear", "--hfov", "70", "--width", "64",
            "--height", "64", "--degree", "3", "--twine", "0",
            "--coeff_cache", str(cdir)]
    core(argv + ["--output", str(tmp_path / "a.exr")])
    entries = list(cdir.glob("coeff_*.npz"))
    assert len(entries) == 1
    first_stat = entries[0].stat().st_mtime_ns

    assets.cache.clear()  # simulate a process restart
    core(argv + ["--output", str(tmp_path / "b.exr")])
    a = imgio.read_image(str(tmp_path / "a.exr"))
    b = imgio.read_image(str(tmp_path / "b.exr"))
    np.testing.assert_array_equal(a, b)
    assert entries[0].stat().st_mtime_ns == first_stat  # reused, not rebuilt

    # invalidate: rewrite the source with different content
    assets.cache.clear()
    imgio.save_image(str(tmp_path / "env.exr"), env * 0.5,
                     projection_name="spherical", hfov_deg=360)
    core(argv + ["--output", str(tmp_path / "c.exr")])
    c = imgio.read_image(str(tmp_path / "c.exr"))
    assert np.abs(c - a).max() > 0.01  # re-prefiltered from new pixels


def test_coeff_bf16_render(tmp_path):
    """--coeff bf16 renders within bf16 rounding of the f32 result."""
    env = synthetic_equirect(256, 128)
    imgio.save_image(str(tmp_path / "env.exr"), env,
                     projection_name="spherical", hfov_deg=360)
    argv = ["--input", str(tmp_path / "env.exr"), "--projection",
            "rectilinear", "--hfov", "70", "--width", "128",
            "--height", "96", "--degree", "3", "--twine", "0"]
    core(argv + ["--output", str(tmp_path / "f32.exr")])
    assets.cache.clear()
    core(argv + ["--coeff", "bf16",
                 "--output", str(tmp_path / "bf16.exr")])
    a = imgio.read_image(str(tmp_path / "f32.exr"))
    b = imgio.read_image(str(tmp_path / "bf16.exr"))
    p = psnr(a, b)
    assert p > 40.0, f"bf16 PSNR {p:.1f} dB"
    assert np.abs(a - b).max() > 0  # actually took the bf16 path


def test_coeff_cache_bf16_roundtrip(tmp_path):
    """--coeff bf16 + --coeff_cache: np.savez cannot represent
    ml_dtypes bfloat16 natively, so the cache stores raw uint16 bits +
    a dtype tag; load() must restore (not treat the entry as corrupt)
    with the bf16 tables bit-identical."""
    import jax.numpy as jnp
    import ml_dtypes

    from envutil.core.conventions import Projection
    from envutil.core.facet import Facet
    from envutil.ops import spline as S
    from envutil.runtime import coeff_cache

    env = synthetic_equirect(64, 32)
    imgio.save_image(str(tmp_path / "env.exr"), env,
                     projection_name="spherical", hfov_deg=360)

    class _A:
        coeff_cache = str(tmp_path / "cc")
        coeff_dtype = "bf16"
        verbose = False

    fct = Facet(facet_no=0, nchannels=3)
    fct.filename = str(tmp_path / "env.exr")
    spl = S.make_spline(jnp.asarray(env), 3,
                        bcs=(S.MIRROR, S.PERIODIC))
    spl = S.Spline2D(coeff=spl.coeff.astype(ml_dtypes.bfloat16),
                     pad=spl.pad, degree=spl.degree, bcs=spl.bcs,
                     core_shape=spl.core_shape, spherical=spl.spherical)
    coeff_cache.store(_A, fct, key="k", spl=spl)
    rspl = coeff_cache.load(_A, fct, key="k")
    assert rspl is not None, "bf16 cache entry treated as a miss"
    assert rspl.coeff.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(rspl.coeff).view(np.uint16),
        np.asarray(spl.coeff).view(np.uint16))


def test_twine_pyramid_minified_downscale(tmp_path):
    """--twine_pyramid: heavily minified facets are box-decimated at
    load so the auto twine shrinks; on smooth (band-limited) content
    the result stays close to the exact K-tap twined render."""
    env = synthetic_equirect(2048, 1024)
    imgio.save_image(str(tmp_path / "env.exr"), env,
                     projection_name="spherical", hfov_deg=360)
    # 2048px 360-deg source -> 256px 100-deg target: mag ~ 0.45
    common = ["--input", str(tmp_path / "env.exr"), "--projection",
              "rectilinear", "--hfov", "100", "--width", "256",
              "--height", "160", "--yaw", "30"]
    core(common + ["--output", str(tmp_path / "exact.exr")])
    core(common + ["--twine_pyramid",
                   "--output", str(tmp_path / "pyr.exr")])
    exact = imgio.read_image(str(tmp_path / "exact.exr"))
    pyr = imgio.read_image(str(tmp_path / "pyr.exr"))
    p = psnr(exact, pyr)
    assert p > 40.0, f"pyramid vs exact twine: {p:.1f} dB"


def test_twine_pyramid_selection_and_guards():
    """Level selection puts the residual magnification in [0.5, 1);
    facets with planar transforms keep full resolution."""
    from envutil.core.conventions import Projection
    from envutil.core.facet import Facet
    from envutil.core.metrics import get_extent, get_step
    from envutil.runtime.args import Args

    def mk(w, h, a=0.0):
        f = Facet(facet_no=0, nchannels=3)
        f.set_geometry(Projection.SPHERICAL, w, h, 2 * math.pi)
        f.a = a
        f.process_geometry()
        return f

    args = Args()
    args.projection = Projection.RECTILINEAR
    args.width, args.height = 256, 160
    args.hfov = math.radians(100)
    args.extent = get_extent(args.projection, 256, 160, args.hfov)
    args.step = (args.extent.x1 - args.extent.x0) / 256
    args.twine_pyramid = True
    f = mk(8192, 4096)
    args.facets = [f]
    args.twine_setup()
    assert f.pyramid_level >= 1
    assert f.width == 8192 >> f.pyramid_level
    assert 0.5 <= f.step / args.step < 1.0 + 1e-9
    assert len(args.twine_spread) <= 9

    # lens-corrected facet: untouched
    args2 = Args()
    args2.projection = Projection.RECTILINEAR
    args2.width, args2.height = 256, 160
    args2.hfov = math.radians(100)
    args2.extent = get_extent(args2.projection, 256, 160, args2.hfov)
    args2.step = (args2.extent.x1 - args2.extent.x0) / 256
    args2.twine_pyramid = True
    f2 = mk(8192, 4096, a=0.01)
    args2.facets = [f2]
    args2.twine_setup()
    assert f2.pyramid_level == 0 and f2.width == 8192


def test_ctc_fov_conversion(tmp_path):
    """--ctc converts a center-to-center cubemap facet's fov to
    edge-to-edge semantics: fov' = 2*atan(tan(fov/2)*(w+1)/w)
    (reference README.md:845-869)."""
    from envutil.core.conventions import Projection
    from envutil.runtime.args import parse_args

    img = np.random.default_rng(3).uniform(
        0, 1, (96, 16, 3)).astype(np.float32)
    imgio.save_image(str(tmp_path / "cm.exr"), img,
                     projection_name="cubemap", hfov_deg=90.0)
    base = ["--input", str(tmp_path / "cm.exr"),
            "--output", str(tmp_path / "o.exr"),
            "--projection", "spherical", "--hfov", "360",
            "--width", "64", "--height", "32"]
    a0 = parse_args(base)
    a1 = parse_args(base + ["--ctc", "1"])
    f0, f1 = a0.facets[0], a1.facets[0]
    assert f0.projection == Projection.CUBEMAP
    exp = 2.0 * math.atan(math.tan(f0.hfov / 2.0) * 17.0 / 16.0)
    assert abs(f1.hfov - exp) < 1e-12
    assert f1.hfov > f0.hfov


def test_input_aspect_inference(tmp_path):
    """--input (this framework's environment-image sugar) infers the
    projection from the aspect ratio when the image carries no
    Projection metadatum: 2:1 -> full spherical, 1:6 -> cubemap - the
    two environment formats envutil takes (envutil_main.cc:39-41).
    --photo keeps the reference's metadata-else-rectilinear-65
    behavior (envutil_basic.h:607-625)."""
    import imageio.v3 as iio
    from envutil.core.conventions import Projection
    from envutil.runtime.args import parse_args

    rng = np.random.default_rng(5)
    iio.imwrite(str(tmp_path / "eq.tiff"),
                rng.uniform(0, 1, (64, 128, 3)).astype(np.float32))
    iio.imwrite(str(tmp_path / "cm.tiff"),
                rng.uniform(0, 1, (96, 16, 3)).astype(np.float32))
    iio.imwrite(str(tmp_path / "ph.tiff"),
                rng.uniform(0, 1, (60, 80, 3)).astype(np.float32))
    tail = ["--output", str(tmp_path / "o.exr"), "--projection",
            "rectilinear", "--hfov", "90", "--width", "32"]

    f = parse_args(["--input", str(tmp_path / "eq.tiff")]
                   + tail).facets[0]
    assert f.projection == Projection.SPHERICAL
    assert abs(f.hfov - 2 * math.pi) < 1e-12

    f = parse_args(["--input", str(tmp_path / "cm.tiff")]
                   + tail).facets[0]
    assert f.projection == Projection.CUBEMAP
    assert abs(f.hfov - math.pi / 2) < 1e-12

    # non-environment aspect falls back to the --photo default
    f = parse_args(["--input", str(tmp_path / "ph.tiff")]
                   + tail).facets[0]
    assert f.projection == Projection.RECTILINEAR
    assert abs(f.hfov - 65.0 * math.pi / 180.0) < 1e-12

    # --photo of a 2:1 image stays reference-faithful: rectilinear 65
    f = parse_args(["--photo", str(tmp_path / "eq.tiff")]
                   + tail).facets[0]
    assert f.projection == Projection.RECTILINEAR
