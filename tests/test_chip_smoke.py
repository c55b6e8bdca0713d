"""chip_smoke.py's phases, run directly at a tiny size on the CPU: the
same CLI, streaming, serve and mesh paths and oracle checks the script
runs at full size on the card."""

import pytest

import chip_smoke as C

TINY = C.Sizes(equirect=128, face=32, big=256, view=(64, 36),
               facet=(96, 72), pano=(128, 64), n_check=256, warm_runs=1)


@pytest.fixture(autouse=True)
def _no_cache_dir(monkeypatch, tmp_path):
    # cli.main places the compile cache; keep it out of the checkout
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))


@pytest.fixture(scope="module")
def head(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("smoke"))
    return tmp, C.phase_headline(tmp, TINY)


def test_prefilter_phase():
    assert C.phase_prefilter(TINY)["max_err"] <= C.PREFILTER_TOL


def test_headline_phase(head):
    assert head[1]["psnr"] >= C.GOLDEN_DB


def test_stream_phase_reuses_the_source(head):
    res = C.phase_stream(head[0], TINY, head[1])
    assert (res["prefilters"], res["hits"]) == (1, 2)
    assert res["psnr"] >= C.GOLDEN_DB


def test_serve_phase(head):
    assert C.phase_serve(head[0], TINY, head[1])["requests"] == 3


def test_twined_phase(tmp_path):
    res = C.phase_twined(str(tmp_path), TINY)
    assert res["taps"] > 1 and res["psnr"] >= C.GOLDEN_DB


def test_stitch_phase(tmp_path):
    assert C.phase_stitch(str(tmp_path), TINY)["psnr"] >= C.GOLDEN_DB


def test_mesh_phase(devices8):
    # the phase itself raises unless --mesh is bit-equal and
    # --shard_table within the ring's 4e-7 contract
    assert C.phase_mesh(TINY, 4)["max_err"] < 1e-6
