"""Option-surface smoke test (VERDICT r4 weak item 6).

``--twine_precise`` parsed cleanly and did nothing for three rounds.
This test makes silently-inert options structurally impossible:

* every option the parser knows must appear either in PERTURBING
  (rendered A/B through the real CLI parse path, output must change)
  or in EXEMPT (with a stated reason - a visible review decision);
* a new ``add_argument`` without a table entry fails the suite.

All runs drive ``cli.core`` - the full argv -> parse_args ->
twine_setup -> render -> save pipeline - so an option that parses but
never reaches the render is caught exactly like one that is dropped
later.
"""

import math

import numpy as np
import pytest

from envutil.io import imgio
from envutil.runtime import assets
from envutil.runtime.args import make_parser
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


# options A/B-verified below: (option, extra argv). Every run renders
# the shared base job plus the listed argv and must change the pixels.
PERTURBING = {
    "--projection": ["--projection", "stereographic"],
    "--hfov": ["--hfov", "80"],
    "--yaw": ["--yaw", "25"],
    "--pitch": ["--pitch", "6"],
    "--roll": ["--roll", "6"],
    # explicit extents are honored only without --hfov (the
    # reference's precedence, envutil: hfov wins when nonzero)
    "--x0": ["--hfov", "0", "--x0", "-0.9", "--x1", "0.8",
             "--y0", "-0.8", "--y1", "0.8"],
    "--x1": "see --x0",
    "--y0": "see --x0",
    "--y1": "see --x0",
    "--brighten": ["--brighten", "1.5"],
    "--degree": ["--degree", "3"],
    "--prefilter": ["--degree", "3", "--prefilter", "0"],
    "--twine": ["--twine", "3"],
    "--twine_width": ["--twine_width", "2.5"],
    "--twine_density": ["--twine_density", "2.0"],
    # sigma/threshold need an odd grid: a 2x2 grid is radially
    # symmetric, so the gaussian re-weights all taps equally and
    # normalizes back to the box - a no-op by construction
    "--twine_sigma": ["--twine", "3", "--twine_sigma", "0.5"],
    "--twine_threshold": ["--twine", "3", "--twine_sigma", "0.3",
                          "--twine_threshold", "0.12"],
    "--twine_precise": ["--twine_precise"],
    "--coeff": ["--degree", "3", "--coeff", "bf16"],
    "--input_colour_space": ["--input_colour_space", "sRGB"],
    "--output_colour_space": ["--output_colour_space", "sRGB"],
    "--nchannels": ["--nchannels", "2"],  # shape change, checked too
}

# options covered by dedicated tests elsewhere, or with no pixel
# semantics by design - each with the reason (the review decision)
EXEMPT = {
    "-v": "logging only",
    "--output": "names the output file (every run here uses it)",
    "--input": "names the input (every run here uses it)",
    "--width": "output shape; every run sets it",
    "--height": "output shape; every run sets it",
    "--support_min": "cubemap IR support margin: test_render "
                     "cubemap sections + test_golden_oracle config 3",
    "--tile_size": "cubemap IR tiling granularity, value-neutral by "
                   "design: test_tiles",
    "--synopsis": "hdr_merge exercised in test_golden_oracle / "
                  "test_modes with multi-facet brackets",
    "--ctc": "rescales CUBEMAP facet fovs only (center-to-center "
             "conversion): test_modes.test_ctc_fov_conversion",
    "--working_colour_space": "pass-through tag written to output "
                              "metadata: test_colour round-trips it",
    "--single": "facet re-creation mode: test_modes",
    "--split": "multi-output mode: test_modes",
    "--solo": "facet selection: test_modes",
    "--mask_for": "mask synthesis mode: test_masks/test_modes",
    "--photo": "facet spec list: test_modes/test_pto",
    "--facet": "facet spec list: test_modes/test_pto",
    "--pto": "facet source: test_pto",
    "--pto_line": "facet source: test_pto",
    "--oiio": "plugin keys forwarded to readers: test_io_surfaces "
              "(raw:*); others warn-and-drop by design",
    "--twf_file": "user kernel file: test_twining reads one; "
                  "inert without a file by definition",
    "--twine_normalize": "only meaningful with --twf_file: "
                         "test_twining",
    "--twine_max": "caps AUTO twine only: test_twining auto_twine "
                   "cases",
    "--twine_pyramid": "load-time decimation for minifying facets: "
                       "test_modes.test_twine_pyramid_minified_downscale",
    "--precise": "accepted so existing command lines still parse; has "
                 "no effect, since every render is exact",
    "--coeff_cache": "on-disk coefficient cache: test_tiles "
                     "round-trips it; value-neutral by contract",
    "--mesh": "device-mesh sharding, bit-equal by contract: "
              "test_parallel",
    "--shard_table": "ring-sharded tables, <=2ulp by contract: "
                     "test_parallel",
}


def test_every_parser_option_is_accounted_for():
    opts = set()
    for action in make_parser()._actions:
        for s in action.option_strings:
            if s in ("-h", "--help"):
                continue
            opts.add(s)
    table = set(PERTURBING) | set(EXEMPT)
    missing = sorted(opts - table)
    assert not missing, (
        f"parser options with no option-surface entry: {missing} - "
        "add an A/B row to PERTURBING or an exemption WITH A REASON "
        "to EXEMPT (tests/test_option_surface.py)")
    stale = sorted(table - opts)
    assert not stale, f"table rows for removed options: {stale}"


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("optsurf")
    env = synthetic_equirect()
    imgio.save_image(str(tmp / "env.exr"), env,
                     projection_name="spherical", hfov_deg=360)
    argv = ["--input", str(tmp / "env.exr"),
            "--projection", "rectilinear", "--hfov", "70",
            "--width", "64", "--height", "64", "--yaw", "10",
            "--pitch", "2", "--twine", "2"]
    core(argv + ["--output", str(tmp / "base.exr")])
    img = imgio.read_image(str(tmp / "base.exr"))
    return tmp, argv, img


@pytest.mark.parametrize("opt", sorted(
    k for k, v in PERTURBING.items() if not isinstance(v, str)))
def test_option_perturbs_output(base, opt):
    tmp, argv, base_img = base
    extra = PERTURBING[opt]
    out = tmp / ("ab" + opt.strip("-") + ".exr")
    core(argv + extra + ["--output", str(out)])
    img = imgio.read_image(str(out))
    if img.shape != base_img.shape:
        return  # a shape change is a perturbation
    assert not np.array_equal(img, base_img), (
        f"{opt} parsed but did not change the rendered output - "
        "silently-inert option")
