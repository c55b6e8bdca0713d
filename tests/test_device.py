"""Device set-up: the compile-cache placement and the GPU requirement
of every path that reports a device measurement."""

import importlib

import jax
import pytest

from envutil.runtime import device


@pytest.fixture
def cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_honours_environment(monkeypatch, tmp_path,
                                           cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert device.setup_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: nothing is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = str(device.CHECKOUT / ".jax_cache")
    assert device.setup_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    # a fixed path: the same on every call
    assert device.setup_compile_cache() == want


@pytest.mark.parametrize("module", ["bench", "benchmarks", "chip_smoke"])
def test_measurement_paths_refuse_the_cpu(module, monkeypatch, tmp_path,
                                          cache_config):
    """bench.py, benchmarks.py and chip_smoke.py stop with an error
    when JAX finds no GPU, before measuring anything."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    mod = importlib.import_module(module)
    with pytest.raises(RuntimeError, match="no GPU"):
        mod.main([])


def test_device_record_names_the_platform():
    rec = device.device_record()
    assert rec == {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())}


@pytest.mark.gpu
def test_gpu_is_found(gpu):
    devs = device.require_gpu()
    assert device.device_record()["platform"] == "gpu"
    assert "," in device.card_info()  # "name, power limit"
    assert devs == jax.devices()
