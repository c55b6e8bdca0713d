"""Test harness configuration.

Tests run on the CPU (``JAX_PLATFORMS=cpu``) with a virtual 8-device
mesh, so that multi-device sharding code paths compile and execute
without several GPUs, and with x64 enabled so geometry property tests
can assert at float64 precision (the reference's geometry.cc tests
assert at 1e-13).

Whether a test can run is decided inside fixtures, never while a
module is imported: the workers of a parallel run must all collect the
same tests.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on an NVIDIA GPU (tests marked ``gpu``;
    chip_smoke.py runs them on the card)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: run on the card by "
                    "chip_smoke.py")


@pytest.fixture
def devices8():
    """The first 8 devices; skip where fewer exist."""
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip(f"needs 8 devices, found {len(devs)}")
    return devs[:8]


def pytest_terminal_summary(terminalreporter, exitstatus, config):
    """Persist the run summary (TESTS_LAST.json at the repo root) so
    test-count claims are checkable artifacts like the bench numbers
    (round-3 advisor finding). Records the invocation args too, so a
    partial selection is distinguishable from the full suite."""
    import json
    import time

    stats = {k: len(v) for k, v in terminalreporter.stats.items() if k}
    out = {
        "when": time.strftime("%Y-%m-%d %H:%M:%S"),
        "exitstatus": int(exitstatus),
        "args": [str(a) for a in config.invocation_params.args],
        "counts": stats,
    }
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "TESTS_LAST.json")
    try:
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")
    except OSError:
        pass
