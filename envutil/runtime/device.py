"""Device set-up shared by the command line, the benchmarks and
``chip_smoke.py``: where JAX keeps its persistent compile cache, and
the GPU requirement of every path that reports a device measurement."""

from __future__ import annotations

import os
import pathlib
import subprocess

import jax

CHECKOUT = pathlib.Path(__file__).resolve().parents[2]


def setup_compile_cache() -> str:
    """Place JAX's persistent compilation cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here. Otherwise the cache lives at the fixed path
    ``<checkout>/.jax_cache``: the path is part of the cache's key, so
    a directory that moves between runs would never hit."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu() -> list:
    """Return ``jax.devices()`` when JAX runs on GPUs, and raise
    otherwise: a measurement taken on the CPU must never be reported
    under a device's name."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX found only {devs[0].platform} device(s) "
            f"({devs[0].device_kind})")
    return devs


def device_record() -> dict:
    """The device as JAX reports it: platform, kind and count."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_info() -> str:
    """The first card's name and power limit as ``nvidia-smi`` reports
    them (``name, power.limit``), read by a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]
