"""On-disk prefiltered-coefficient cache.

The reference has no checkpointing; its closest notions are the in-RAM
asset cache persisting prefiltered facets across streamed jobs
(environment.h:84-227) and tiles.h writing tiles to disk. This module
is the durable half the SURVEY flags (SURVEY.md §5 checkpoint/resume):
prefiltered spline coefficients are written to an ``.npz`` per asset,
keyed by the asset key plus the source file's identity (size + mtime),
so a restarted streaming/serve process resumes without re-prefiltering
8K+ sources.

Enabled by ``--coeff_cache DIR`` or ``ENVUTIL_COEFF_CACHE=DIR``.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
from typing import Optional

import numpy as np

from ..ops import spline as S


def cache_dir(args) -> Optional[pathlib.Path]:
    d = getattr(args, "coeff_cache", None) \
        or os.environ.get("ENVUTIL_COEFF_CACHE")
    return pathlib.Path(d) if d else None


def _entry_path(cdir: pathlib.Path, fct, key, args=None) -> pathlib.Path:
    # the stored tables carry the storage dtype (--coeff), so the
    # entry identity must include it
    ident = [repr(key),
             getattr(args, "coeff_dtype", "f32") if args else "f32"]
    # file identity: a changed source invalidates the entry
    fn = fct.filename
    names = ([fn % face for face in
              ("left", "right", "top", "bottom", "front", "back")]
             if "%s" in fn else [fn])
    for n in names:
        try:
            st = os.stat(n)
            ident.append(f"{n}:{st.st_size}:{st.st_mtime_ns}")
        except OSError:
            ident.append(f"{n}:absent")
    h = hashlib.sha256("\n".join(ident).encode()).hexdigest()[:32]
    return cdir / f"coeff_{h}.npz"


def _pack_spline(d: dict, prefix: str, spl: S.Spline2D) -> None:
    coeff = np.asarray(spl.coeff)
    # np.savez writes ml_dtypes arrays (bfloat16 etc.) as opaque void
    # records that cannot be read back: store the raw bits as uint16
    # and tag the real dtype so load reconstructs it with .view()
    dtype_tag = coeff.dtype.name
    if dtype_tag not in ("float32", "float64", "float16"):
        d[prefix + "coeff"] = np.ascontiguousarray(coeff).view(np.uint16)
    else:
        d[prefix + "coeff"] = coeff
    d[prefix + "dtype"] = np.array([dtype_tag])
    d[prefix + "meta"] = np.array(
        [spl.pad, spl.degree, spl.core_shape[0], spl.core_shape[1],
         int(spl.spherical)], np.int64)
    d[prefix + "bcs"] = np.array([str(spl.bcs[0]), str(spl.bcs[1])])


def _unpack_spline(z, prefix: str) -> S.Spline2D:
    import jax.numpy as jnp
    pad, degree, ch, cw, sph = [int(v) for v in z[prefix + "meta"]]
    bcs = tuple(str(b) for b in z[prefix + "bcs"])
    coeff = z[prefix + "coeff"]
    if prefix + "dtype" in z:
        tag = str(z[prefix + "dtype"][0])
        if coeff.dtype.name != tag:
            import ml_dtypes
            coeff = coeff.view(np.dtype(getattr(ml_dtypes, tag)))
    return S.Spline2D(coeff=jnp.asarray(coeff), pad=pad,
                      degree=degree, bcs=bcs, core_shape=(ch, cw),
                      spherical=bool(sph))


def load(args, fct, key) -> Optional[S.Spline2D]:
    """Return the cached spline from the disk cache, or None."""
    cdir = cache_dir(args)
    if cdir is None:
        return None
    path = _entry_path(cdir, fct, key, args)
    if not path.exists():
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            spl = _unpack_spline(z, "main_")
    except Exception:
        return None  # treat a corrupt entry as a miss
    if getattr(args, "verbose", False):
        print(f"asset {fct.asset_key}: coefficients restored from "
              f"{path}")
    return spl


def store(args, fct, key, spl) -> None:
    cdir = cache_dir(args)
    if cdir is None or spl is None:
        return
    cdir.mkdir(parents=True, exist_ok=True)
    path = _entry_path(cdir, fct, key, args)
    d = {}
    _pack_spline(d, "main_", spl)
    tmp = path.with_suffix(".tmp.npz")
    with open(tmp, "wb") as f:
        np.savez(f, **d)
    os.replace(tmp, path)  # atomic publish (restart-safe)
    if getattr(args, "verbose", False):
        print(f"asset {fct.asset_key}: coefficients cached to {path}")
