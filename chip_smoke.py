"""Smoke test of envutil on NVIDIA GPUs: the quickest proof that the
system starts and renders correctly on the card.

With no arguments it needs one GPU and runs the command line's main
paths once, at full size, each result checked against the independent
float64 oracle of ``tests/oracle.py`` on seeded target pixels:

  card       nvidia-smi's name and power limit, JAX's device, the
             compile-cache directory
  prefilter  the spline prefilter on the card against the oracle's
             collocation solve, and its time on the 8K source
  headline   8K equirect -> 6x2048 cubemap, degree 3 (``cli.core``)
  twined     16K equirect -> 1920x1080 rectilinear, automatic twining
  stitch     3-facet PTO voronoi stitch with lens a/b/c -> 4096x2048
  stream     streaming mode '-': three jobs over one source
  serve      serve mode '+': ``serve.render_loop`` in a thread of this
             process answers three requests
  gpu-tests  the tests marked ``gpu`` (they skip on the CPU)

``--devices 4`` runs only the multi-device path (``--mesh 4`` and
``--mesh 4 --shard_table``) and the single-device render it is
compared with.

Run it from the root of a checkout::

    python chip_smoke.py
    python chip_smoke.py --devices 4

Every phase that fails ends the run with a non-zero exit code. Source
data is made from fixed seeds. The last line of standard output is one
JSON object: {"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": N}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import socket
import statistics
import struct
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "tests"))

import oracle as O  # noqa: E402
from envutil.io import imgio  # noqa: E402
from envutil.runtime import assets, cli, device, serve  # noqa: E402
from envutil.runtime import render as R  # noqa: E402

GOLDEN_DB = 50.0
# prefilter on the card vs the float64 collocation solve: float32
# rounding of a sum of up to ~30 taps of a geometrically decaying
# filter over data in [0, 1]
PREFILTER_TOL = 2e-5


@dataclasses.dataclass(frozen=True)
class Sizes:
    equirect: int = 8192          # 2:1 headline source width
    face: int = 2048              # cubemap face of the headline
    big: int = 16384              # 2:1 source of the twined downscale
    view: tuple = (1920, 1080)    # twined and served views
    facet: tuple = (2048, 1536)   # each facet of the stitch
    pano: tuple = (4096, 2048)    # the stitch's equirect output
    n_check: int = 4096           # seeded pixels compared with the oracle
    warm_runs: int = 5


FULL = Sizes()


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def seeded_image(h: int, w: int, seed: int, nch: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).random((h, w, nch), np.float32)


def seeded_pixels(h: int, w: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    return rng.integers(0, h, n), rng.integers(0, w, n)


def check(phase: str, out: np.ndarray, ref: np.ndarray) -> float:
    """Finite values that agree with the oracle at >= 50 dB."""
    if not np.all(np.isfinite(out)):
        raise AssertionError(f"{phase}: non-finite output")
    p = O.psnr(out, ref)
    say(phase, f"oracle check on {len(ref)} seeded pixels: "
               f"{p:.2f} dB (limit {GOLDEN_DB} dB)")
    if not p >= GOLDEN_DB:
        raise AssertionError(f"{phase}: {p:.2f} dB < {GOLDEN_DB} dB")
    return p


def peak_gib() -> str:
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return f"{stats.get('peak_bytes_in_use', 0) / 2**30:.3f} GiB"


def run_cli(argv) -> float:
    """One job through ``cli.core``; returns its frame time in ms."""
    cli.core(list(argv))
    return R.render_frame.last_ms


def write_equirect(path: str, w: int, seed: int) -> np.ndarray:
    img = seeded_image(w // 2, w, seed)
    imgio.write_pfm(path, img)
    return img


# ------------------------------------------------------------- phases

def phase_card() -> None:
    import jax
    print(device.card_info(), flush=True)
    d = jax.devices()
    say("card", f"device_kind {d[0].device_kind}, {len(d)} device(s), "
                f"platform {d[0].platform}")
    say("card", f"compile cache {device.setup_compile_cache()}")


def phase_prefilter(s: Sizes) -> dict:
    """The prefilter on the device against the oracle, and the time of
    the headline source's full spherical prefilter."""
    import jax
    import jax.numpy as jnp

    from envutil.ops import spline as S
    worst = 0.0
    sig = seeded_image(1024, 16, 11)
    for degree in range(2, 8):
        for bc in (S.MIRROR, S.PERIODIC):
            got = np.asarray(S.prefilter_axis(jnp.asarray(sig), 0,
                                              degree, bc))
            err = float(np.max(np.abs(got - O.prefilter_1d(sig, degree,
                                                           bc))))
            worst = max(worst, err)
    say("prefilter", f"degrees 2-7 x (mirror, periodic) vs the oracle: "
                     f"max |d| {worst:.3e} (limit {PREFILTER_TOL})")
    if not worst <= PREFILTER_TOL:
        raise AssertionError(f"prefilter: {worst} > {PREFILTER_TOL}")
    img = jax.device_put(seeded_image(s.equirect // 2, s.equirect, 0))
    pf = jax.jit(lambda a: S.spherical_prefilter(a, 3))
    jax.block_until_ready(pf(img))
    times = []
    for _ in range(s.warm_runs):
        t0 = time.perf_counter()
        jax.block_until_ready(pf(img))
        times.append((time.perf_counter() - t0) * 1e3)
    say("prefilter", f"degree-3 spherical prefilter of the "
                     f"{s.equirect}x{s.equirect // 2} source on the "
                     f"device: median {statistics.median(times):.3f} ms "
                     f"of {[round(t, 3) for t in times]}")
    return {"max_err": worst}


def phase_headline(tmp: str, s: Sizes) -> dict:
    """8K equirect -> 6x2048 cubemap, degree 3, through ``cli.core``."""
    import jax
    from envutil.runtime import loader
    from envutil.runtime.args import parse_args

    src = os.path.join(tmp, "equirect.pfm")
    img = write_equirect(src, s.equirect, 0)
    out = os.path.join(tmp, "cubemap.pfm")
    argv = ["--input", src, "--projection", "cubemap", "--width",
            str(s.face), "--hfov", "90", "--degree", "3", "--twine", "0",
            "--output", out]
    assets.cache.clear()
    t0 = time.perf_counter()
    first = run_cli(argv)
    say("headline", f"first job {time.perf_counter() - t0:.3f} s "
                    f"(read, prefilter, compile, render, write); its "
                    f"frame {first:.3f} ms including compilation")
    frames, jobs = [], []
    for _ in range(s.warm_runs):
        t0 = time.perf_counter()
        frames.append(run_cli(argv))
        jobs.append((time.perf_counter() - t0) * 1e3)
    say("headline", f"later jobs' frame (render_frame: trace, compile, "
                    f"device, copy to host) median "
                    f"{statistics.median(frames):.3f} ms of "
                    f"{[round(t, 3) for t in frames]}; job median "
                    f"{statistics.median(jobs):.3f} ms; frame programs "
                    f"built so far: {R._compiled_window.cache_info()}")

    args = parse_args(argv)
    args.twine_setup()
    srcs = [loader.load_source(f, args) for f in args.facets]
    plan = R.build_plan(args, args.facets)
    window = (0, plan.height, 0, plan.width)
    fn = R._compiled_window(plan, window)
    t0 = time.perf_counter()
    compiled = fn.lower(srcs).compile()
    say("headline", f"trace + compile of the frame program "
                    f"{time.perf_counter() - t0:.3f} s; memory_analysis: "
                    f"{compiled.memory_analysis()}")
    bare = []
    for _ in range(s.warm_runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(srcs))
        bare.append((time.perf_counter() - t0) * 1e3)
    say("headline", f"bare jitted frame median "
                    f"{statistics.median(bare):.4f} ms of "
                    f"{[round(t, 4) for t in bare]}; peak device memory "
                    f"{peak_gib()}")
    assets.conclude_cycle()

    cube = imgio.read_pfm(out)
    if cube.shape != (6 * s.face, s.face, 3):
        raise AssertionError(f"headline: output shape {cube.shape}")
    ofct = O.MountFacet(O.SPHERICAL, s.equirect, s.equirect // 2,
                        2 * math.pi, img, degree=3)
    pix = seeded_pixels(6 * s.face, s.face, s.n_check, 1)
    ref = O.render(dict(projection=O.CUBEMAP, width=s.face,
                        height=6 * s.face, hfov=math.pi / 2), [ofct],
                   pixels=pix)
    psnr = check("headline", cube[pix], ref)
    return {"psnr": psnr, "source": src, "image": img, "oracle": ofct}


def phase_twined(tmp: str, s: Sizes) -> dict:
    """16K equirect -> 1920x1080 rectilinear with automatic twining."""
    src = os.path.join(tmp, "big.pfm")
    img = write_equirect(src, s.big, 2)
    out = os.path.join(tmp, "view.pfm")
    vw, vh = s.view
    argv = ["--input", src, "--projection", "rectilinear", "--width",
            str(vw), "--height", str(vh), "--hfov", "90", "--degree", "3",
            "--output", out]
    assets.cache.clear()
    t0 = time.perf_counter()
    first = run_cli(argv)
    say("twined", f"first job {time.perf_counter() - t0:.3f} s; its "
                  f"frame {first:.3f} ms including compilation")
    warm = [run_cli(argv) for _ in range(s.warm_runs)]
    say("twined", f"later jobs' frame (trace, compile, device, copy) "
                  f"median {statistics.median(warm):.3f} ms "
                  f"of {[round(t, 3) for t in warm]}; peak device "
                  f"memory {peak_gib()}")
    assets.cache.clear()
    view = imgio.read_pfm(out)
    if view.shape != (vh, vw, 3):
        raise AssertionError(f"twined: output shape {view.shape}")
    # the oracle's own automatic twining (twine_setup)
    hfov = math.pi / 2
    mag = (O.get_step(O.SPHERICAL, s.big, s.big // 2, 2 * math.pi)
           / O.get_step(O.RECTILINEAR, vw, vh, hfov))
    twine, width = O.auto_twine(mag, 3, 1)
    spread = O.make_spread(twine, twine, width)
    say("twined", f"magnification {mag:.4f}: {len(spread)} taps")
    ofct = O.MountFacet(O.SPHERICAL, s.big, s.big // 2, 2 * math.pi, img,
                        degree=3)
    pix = seeded_pixels(vh, vw, s.n_check, 3)
    ref = O.render(dict(projection=O.RECTILINEAR, width=vw, height=vh,
                        hfov=hfov), [ofct], spread=spread, pixels=pix)
    return {"psnr": check("twined", view[pix], ref), "taps": len(spread)}


STITCH_LENS = dict(a=0.01, b=-0.02, c=0.005)
STITCH_POSES = ((-40.0, 5.0, 0.0), (0.0, -5.0, 1.0), (40.0, 5.0, -1.0))


def phase_stitch(tmp: str, s: Sizes) -> dict:
    """3-facet PTO voronoi stitch with lens a/b/c -> equirect pano."""
    fw, fh = s.facet
    pw, ph = s.pano
    lines = [f"p f2 w{pw} h{ph} v360"]
    images = []
    for i, (yaw, pitch, roll) in enumerate(STITCH_POSES):
        path = os.path.join(tmp, f"facet{i}.pfm")
        images.append(seeded_image(fh, fw, 10 + i))
        imgio.write_pfm(path, images[-1])
        lines.append(f"i w{fw} h{fh} f0 v65 y{yaw} p{pitch} r{roll} "
                     f"a{STITCH_LENS['a']} b{STITCH_LENS['b']} "
                     f"c{STITCH_LENS['c']} n\"{path}\"")
    pto = os.path.join(tmp, "stitch.pto")
    with open(pto, "w") as f:
        f.write("\n".join(lines) + "\n")
    out = os.path.join(tmp, "pano.pfm")
    argv = ["--pto", pto, "--degree", "3", "--twine", "0", "--output", out]
    assets.cache.clear()
    t0 = time.perf_counter()
    first = run_cli(argv)
    say("stitch", f"first job {time.perf_counter() - t0:.3f} s; its "
                  f"frame {first:.3f} ms including compilation")
    warm = [run_cli(argv) for _ in range(s.warm_runs)]
    say("stitch", f"later jobs' frame (trace, compile, device, copy) "
                  f"median {statistics.median(warm):.3f} ms "
                  f"of {[round(t, 3) for t in warm]}; peak device "
                  f"memory {peak_gib()}")
    assets.cache.clear()
    pano = imgio.read_pfm(out)
    if pano.shape != (ph, pw, 3):
        raise AssertionError(f"stitch: output shape {pano.shape}")
    hfov = math.radians(65)
    ext = O.get_extent(O.RECTILINEAR, fw, fh, hfov)
    ofacets = [O.MountFacet(O.RECTILINEAR, fw, fh, hfov, im,
                            yaw=math.radians(y), pitch=math.radians(p),
                            roll=math.radians(r), degree=3,
                            lens=O.Lens(extent=ext, width=fw,
                                        **STITCH_LENS))
               for im, (y, p, r) in zip(images, STITCH_POSES)]
    pix = seeded_pixels(ph, pw, s.n_check, 4)
    ref = O.render(dict(projection=O.SPHERICAL, width=pw, height=ph,
                        hfov=2 * math.pi), ofacets, pixels=pix)
    return {"psnr": check("stitch", pano[pix], ref)}


def _view_reference(head: dict, s: Sizes, yaw: float, n: int, seed: int):
    vw, vh = s.view
    pix = seeded_pixels(vh, vw, n, seed)
    ref = O.render(dict(projection=O.RECTILINEAR, width=vw, height=vh,
                        hfov=math.pi / 2, yaw=math.radians(yaw)),
                   [head["oracle"]], pixels=pix)
    return pix, ref


def phase_stream(tmp: str, s: Sizes, head: dict) -> dict:
    """Streaming mode '-': three jobs over the headline source; jobs 2
    and 3 must find it in the asset cache and not prefilter again."""
    vw, vh = s.view
    yaws = (0.0, 60.0, -75.0)
    jobs = [f"--projection rectilinear --width {vw} --height {vh} "
            f"--hfov 90 --yaw {y} --output "
            f"{os.path.join(tmp, f'stream{i}.pfm')}"
            for i, y in enumerate(yaws)]
    assets.cache.clear()
    log = io.StringIO()
    old_stdin = sys.stdin
    sys.stdin = io.StringIO("\n".join(jobs) + "\n")
    try:
        with contextlib.redirect_stdout(log):
            cli.main(["--input", head["source"], "--degree", "3",
                      "--twine", "0", "-v", "-"])
    finally:
        sys.stdin = old_stdin
    text = log.getvalue()
    prefilters = text.count("b-spline prefilter")
    hits = text.count("is already present in RAM")
    say("stream", f"3 jobs: {prefilters} prefilter(s), {hits} asset "
                  f"cache hit(s)")
    if (prefilters, hits) != (1, 2):
        raise AssertionError("stream: jobs 2 and 3 did not reuse the "
                             "prefiltered source")
    worst = math.inf
    for i, yaw in enumerate(yaws):
        view = imgio.read_pfm(os.path.join(tmp, f"stream{i}.pfm"))
        pix, ref = _view_reference(head, s, yaw, s.n_check // 4, 20 + i)
        worst = min(worst, check("stream", view[pix], ref))
    assets.cache.clear()
    return {"prefilters": prefilters, "hits": hits, "psnr": worst}


def _send(conn, obj) -> None:
    data = json.dumps(obj).encode()
    conn.sendall(struct.pack("<I", len(data)) + data)


def _recv(conn):
    (n,) = struct.unpack("<I", conn.recv(4, socket.MSG_WAITALL))
    hdr = json.loads(conn.recv(n, socket.MSG_WAITALL).decode())
    payload = b""
    if "width" in hdr and "error" not in hdr:
        payload = conn.recv(hdr["width"] * hdr["height"] * 4,
                            socket.MSG_WAITALL)
    return hdr, payload


def phase_serve(tmp: str, s: Sizes, head: dict) -> dict:
    """Serve mode '+': ``serve.render_loop`` in a thread answers three
    requests from a client in this process (one JAX process)."""
    sock_path = os.path.join(tmp, "serve.sock")
    assets.cache.clear()
    errors = []

    def loop():
        try:
            serve.render_loop(sock_path)
        except Exception as exc:  # reported by the main thread below
            errors.append(exc)
    server = threading.Thread(target=loop, daemon=True)
    server.start()
    for _ in range(600):
        if os.path.exists(sock_path) or errors:
            break
        time.sleep(0.05)
    if errors or not os.path.exists(sock_path):
        raise AssertionError(f"serve: server did not start {errors}")
    vw, vh = s.view
    yaws = (20.0, -110.0, 175.0)
    worst = math.inf
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as conn:
        conn.connect(sock_path)
        for i, yaw in enumerate(yaws, start=1):
            t0 = time.perf_counter()
            _send(conn, {"serial_no": i, "width": vw, "height": vh,
                         "yaw": yaw, "hfov": 90,
                         "args": ["--input", head["source"],
                                  "--degree", "3"]})
            hdr, payload = _recv(conn)
            ms = (time.perf_counter() - t0) * 1e3
            if hdr.get("serial_no") != i or "error" in hdr:
                raise AssertionError(f"serve: bad answer {hdr}")
            frame = np.frombuffer(payload, np.uint32).reshape(vh, vw)
            pix, ref = _view_reference(head, s, yaw, s.n_check // 4,
                                       30 + i)
            want = serve.to_screen(ref[:, None, :])[:, 0]
            diff = max(int(np.max(np.abs(
                ((frame[pix] >> sh) & 0xFF).astype(np.int64)
                - ((want >> sh) & 0xFF).astype(np.int64))))
                for sh in (0, 8, 16))
            say("serve", f"request {i}: {vw}x{vh} frame in {ms:.3f} ms "
                         f"(render {hdr['t_render']:.3f} ms), max 8-bit "
                         f"difference to the oracle {diff}")
            if diff > 1:
                raise AssertionError(f"serve: 8-bit difference {diff}")
        _send(conn, {"serial_no": 0})
        if _recv(conn)[0] != {"serial_no": 0}:
            raise AssertionError("serve: no shutdown answer")
    server.join(timeout=60)
    if server.is_alive() or errors:
        raise AssertionError(f"serve: server did not stop {errors}")
    assets.cache.clear()
    return {"requests": len(yaws)}


def phase_mesh(s: Sizes, n: int) -> dict:
    """``--mesh n`` and ``--mesh n --shard_table`` on the headline job
    against the single-device render of the same job."""
    import jax

    from envutil.core.conventions import Projection
    from envutil.core.facet import Facet
    from envutil.core.metrics import get_extent, get_step
    from envutil.models import environment as E
    from envutil.parallel import mesh as PM
    from envutil.runtime.args import Args

    w = s.equirect
    fct = Facet(facet_no=0, nchannels=3)
    fct.set_geometry(Projection.SPHERICAL, w, w // 2, 2 * math.pi)
    fct.step = get_step(Projection.SPHERICAL, w, w // 2, 2 * math.pi)
    fct.process_geometry()
    src = E.make_mount_source(fct, seeded_image(w // 2, w, 0), 3, 3)
    a = Args()
    a.projection = Projection.CUBEMAP
    a.width, a.height = s.face, 6 * s.face
    a.hfov = math.pi / 2
    a.extent = get_extent(a.projection, a.width, a.height, a.hfov)
    a.step = (a.extent.x1 - a.extent.x0) / a.width
    a.spline_degree = a.prefilter_degree = 3
    a.twine = 0
    a.synopsis = "panorama"
    a.nchannels = 3
    a.facets = [fct]
    a.solo = 0
    plan = R.build_plan(a, [fct])

    single = R.render_frame(plan, [src])
    meshed = R.render_frame(plan, [src], mesh_n=n)
    say("mesh", f"--mesh {n}: frame {R.render_frame.last_ms:.3f} ms, "
                f"bit-equal to one device: "
                f"{np.array_equal(meshed, single)}")
    if not np.array_equal(meshed, single):
        raise AssertionError(f"mesh: max |d| "
                             f"{np.max(np.abs(meshed - single))}")
    ringed = R.render_frame(plan, [src], mesh_n=n, shard_table=True)
    err = float(np.max(np.abs(ringed - single)))
    say("mesh", f"--mesh {n} --shard_table: frame "
                f"{R.render_frame.last_ms:.3f} ms, max |d| {err:.3e}")
    np.testing.assert_allclose(ringed, single, rtol=4e-7, atol=4e-7)

    mesh = PM.make_mesh(jax.devices()[:n])
    srcs = PM.replicate_sources([src], mesh)
    spans = len(PM.sharded_render(plan, srcs, mesh)(srcs)
                .sharding.device_set)
    srcs = PM.shard_sources([src], mesh)
    ring_spans = len(PM.ring_sharded_render(plan, srcs, mesh)(srcs)
                     .sharding.device_set)
    say("mesh", f"output sharding spans {spans} devices (replicated "
                f"tables) and {ring_spans} (ring-sharded tables)")
    if (spans, ring_spans) != (n, n):
        raise AssertionError("mesh: output not sharded over the mesh")
    return {"max_err": err}


def phase_gpu_tests() -> None:
    """The tests marked ``gpu``, which skip on the CPU, run here."""
    import pytest
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests")])
    say("gpu-tests", f"pytest -m gpu: exit code {rc}")
    if rc != 0:
        raise AssertionError(f"gpu tests failed: exit code {rc}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-device path")
    ns = ap.parse_args(argv)
    device.setup_compile_cache()
    devs = device.require_gpu()
    if len(devs) < ns.devices:
        raise RuntimeError(f"--devices {ns.devices}: JAX found "
                           f"{len(devs)} GPU(s)")
    phase_card()
    if ns.devices > 1:
        phase_mesh(FULL, ns.devices)
    else:
        phase_prefilter(FULL)
        with tempfile.TemporaryDirectory() as tmp:
            head = phase_headline(tmp, FULL)
            phase_stream(tmp, FULL, head)
            phase_serve(tmp, FULL, head)
            del head
            phase_twined(tmp, FULL)
            phase_stitch(tmp, FULL)
        phase_gpu_tests()
    print(json.dumps({"ok": True, "device": device.device_record()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
