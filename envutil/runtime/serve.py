"""Interactive serve mode (the reference's 'tethered' visor protocol,
visor.h + envutil_main.cc:1755-1869).

The reference renders into shared-memory frame buffers handed over by
a GUI process ('visor'), with a bounded frame queue for back-pressure.
Here the transport is a Unix domain socket speaking a small length-
prefixed JSON protocol; the render side keeps facet assets on-device
across frames and returns packed sRGBA uint32 frames, preserving the
pipeline-timing fields of the reference's spec_t (visor.h:76-137).

Protocol (one JSON object per message, little-endian uint32 length
prefix; binary frame payload follows the frame header message):

  client -> server: {"args": [...], "width": W, "height": H,
                     "yaw": deg, "pitch": deg, "roll": deg,
                     "hfov": deg, "serial_no": N}
  server -> client: {"serial_no": N, "width": W, "height": H,
                     "t_in": ..., "t_render": ..., "t_out": ...}
                    + W*H*4 bytes of sRGBA pixels

serial_no == 0 requests shutdown (visor.h:578).
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time

import numpy as np

from ..io.imgio import linear_to_srgb
from . import assets
from .args import parse_args
from .loader import load_source
from .render import build_plan, render_frame

SOCKET_PATH = os.environ.get("ENVUTIL_SOCKET", "/tmp/envutil.sock")


def to_screen(img: np.ndarray) -> np.ndarray:
    """float linear (H, W, C) -> packed sRGBA uint32 (to_screen_t,
    envutil_payload.cc:289-413)."""
    h, w, c = img.shape
    if c == 1:
        rgb = np.repeat(img, 3, axis=-1)
        alpha = np.ones((h, w, 1), np.float32)
    elif c == 2:
        rgb = np.repeat(img[..., :1], 3, axis=-1)
        alpha = img[..., 1:2]
    elif c == 3:
        rgb = img
        alpha = np.ones((h, w, 1), np.float32)
    else:
        rgb = img[..., :3]
        alpha = img[..., 3:4]
    srgb = np.clip(linear_to_srgb(rgb) * 255.0 + 0.5, 0, 255
                   ).astype(np.uint32)
    a = np.clip(linear_to_srgb(alpha) * 255.0 + 0.5, 0, 255
                ).astype(np.uint32)
    packed = (a[..., 0] << 24) | (srgb[..., 2] << 16) \
        | (srgb[..., 1] << 8) | srgb[..., 0]
    return packed.astype(np.uint32)


def _recv_msg(conn):
    head = conn.recv(4, socket.MSG_WAITALL)
    if len(head) < 4:
        return None
    (n,) = struct.unpack("<I", head)
    data = conn.recv(n, socket.MSG_WAITALL)
    return json.loads(data.decode())


def _send_msg(conn, obj, payload: bytes = b""):
    data = json.dumps(obj).encode()
    conn.sendall(struct.pack("<I", len(data)) + data + payload)


def handle_job(spec: dict) -> tuple:
    """Rebuild an argv from the job spec and render one frame
    (handle_job, envutil_main.cc:1755-1869)."""
    argv = ["--output", spec.get("filename", "none.jpg"),
            "--twine", "-1" if spec.get("refine") else "0",
            "--hfov", "65"]
    argv += [str(a) for a in spec.get("args", [])]
    argv += ["--width", str(spec["width"]), "--height", str(spec["height"]),
             "--yaw", str(spec.get("yaw", 0.0)),
             "--pitch", str(spec.get("pitch", 0.0)),
             "--roll", str(spec.get("roll", 0.0)),
             "--hfov", str(spec.get("hfov", 65.0))]
    if spec.get("brighten", 1.0) != 1.0:
        argv += ["--brighten", str(spec["brighten"])]
    args = parse_args(argv)
    args.tethered = True
    args.twine_setup()
    sources = [load_source(f, args) for f in args.facets]
    plan = build_plan(args, args.facets)
    active = [sources[i] for i in plan.facet_indices]
    t0 = time.perf_counter()
    img = render_frame(plan, active, verbose=args.verbose)
    t1 = time.perf_counter()
    frame = to_screen(img)
    assets.conclude_cycle()
    return frame, {"t_render": (t1 - t0) * 1000.0}


def render_loop(socket_path: str = SOCKET_PATH) -> None:
    """Serve frames until a shutdown job arrives. Bad jobs answer with
    an error message instead of killing the loop (the reference's
    streaming loop dies on errors; for serving we stay up)."""
    try:
        os.unlink(socket_path)
    except FileNotFoundError:
        pass
    server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    server.bind(socket_path)
    server.listen(1)
    print(f"envutil serving on {socket_path}")
    while True:
        conn, _ = server.accept()
        try:
            while True:
                spec = _recv_msg(conn)
                if spec is None:
                    break
                if spec.get("serial_no", 1) == 0:
                    _send_msg(conn, {"serial_no": 0})
                    conn.close()
                    server.close()
                    return
                t_in = time.time()
                try:
                    frame, timing = handle_job(spec)
                except Exception as exc:  # keep serving on bad jobs
                    _send_msg(conn, {"serial_no": spec.get("serial_no"),
                                     "error": str(exc)})
                    continue
                header = {"serial_no": spec.get("serial_no"),
                          "width": int(frame.shape[1]),
                          "height": int(frame.shape[0]),
                          "t_in": t_in, "t_out": time.time(), **timing}
                _send_msg(conn, header, frame.tobytes())
        finally:
            conn.close()
