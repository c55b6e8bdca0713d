"""Serve-mode protocol test: frames over the unix socket, asset reuse,
bad-job resilience, shutdown (the visor-protocol equivalent,
visor.h:458-650)."""

import json
import math
import os
import socket
import struct
import subprocess
import sys
import time

import numpy as np
import pytest

from envutil.io import imgio


@pytest.mark.timeout(300)
def test_serve_roundtrip(tmp_path):
    w, h = 128, 64
    lon = (np.arange(w) + 0.5) / w * 2 * math.pi - math.pi
    img = np.zeros((h, w, 3), np.float32)
    img[..., 0] = (lon[None, :] + math.pi) / (2 * math.pi)
    env_file = tmp_path / "env.exr"
    imgio.save_image(str(env_file), img, projection_name="spherical",
                     hfov_deg=360)

    sock_path = str(tmp_path / "serve.sock")
    env = dict(os.environ, ENVUTIL_SOCKET=sock_path,
               JAX_PLATFORMS="cpu")
    server = subprocess.Popen(
        [sys.executable, "-m", "envutil.runtime.cli",
         "--input", str(env_file), "--twine", "0", "+"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        for _ in range(240):
            if os.path.exists(sock_path):
                break
            time.sleep(0.5)
        else:
            raise AssertionError("server never bound its socket")

        c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        c.connect(sock_path)

        def send(obj):
            d = json.dumps(obj).encode()
            c.sendall(struct.pack("<I", len(d)) + d)

        def recv():
            (n,) = struct.unpack("<I", c.recv(4, socket.MSG_WAITALL))
            hdr = json.loads(c.recv(n, socket.MSG_WAITALL).decode())
            payload = b""
            if "width" in hdr and "error" not in hdr:
                payload = c.recv(hdr["width"] * hdr["height"] * 4,
                                 socket.MSG_WAITALL)
            return hdr, payload

        send({"serial_no": 1, "width": 64, "height": 32, "yaw": 90.0,
              "hfov": 90,
              "args": ["--input", str(env_file), "--twine", "0"]})
        hdr, payload = recv()
        assert hdr["serial_no"] == 1 and "t_render" in hdr
        frame = np.frombuffer(payload, np.uint32).reshape(32, 64)
        # camera yawed +90: center red = lon pi/2 -> 0.75 linear -> sRGB
        r = (frame[16, 32] & 0xFF) / 255.0
        assert abs(r - float(imgio.linear_to_srgb(
            np.float32(0.75)))) < 0.03
        # alpha byte opaque
        assert (frame[16, 32] >> 24) == 255

        # a bad job answers with an error and the loop survives
        send({"serial_no": 2, "width": 32, "height": 32,
              "args": ["--projection", "bogus"]})
        hdr, _ = recv()
        assert "error" in hdr

        send({"serial_no": 0})
        hdr, _ = recv()
        assert hdr == {"serial_no": 0}
        server.wait(timeout=60)
    finally:
        if server.poll() is None:
            server.kill()


def test_visor_disconnect_with_held_buffers(tmp_path):
    """Regression: a client that disconnects while holding all pipeline
    slots (>= FRAME_QUEUE_DEPTH unreleased frames, more jobs queued)
    must not deadlock the render thread; the next connection is served
    (render thread wakes via the per-connection stop event)."""
    import threading

    from envutil.runtime import visor

    sock_path = str(tmp_path / "visor.sock")

    def render_fn(spec):
        return np.full((8, 8), spec["serial_no"], np.uint32)

    srv = visor.VisorServer(render_fn, sock_path, width=16, height=16,
                            shm_prefix=f"test_visor_{os.getpid()}")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    for _ in range(100):
        if os.path.exists(sock_path):
            break
        time.sleep(0.05)

    # first client: queue depth+2 jobs, release nothing, vanish
    c1 = visor.VisorClient(sock_path)
    for i in range(visor.FRAME_QUEUE_DEPTH + 2):
        c1.submit({"job": i})
    # wait until the pipeline is saturated (depth frames announced)
    for _ in range(visor.FRAME_QUEUE_DEPTH):
        hdr = visor._recv_msg(c1.conn)
        assert "buffer" in hdr
    c1.conn.close()
    c1.store.close()

    # second client must get a frame (bounded wait = the regression)
    c2 = visor.VisorClient(sock_path, timeout=30.0)
    c2.submit({"job": "again"})
    hdr, px = c2.next_frame()
    assert px[0, 0] == hdr["serial_no"]
    c2.shutdown()
    c2.close()
    t.join(timeout=30)
    assert not t.is_alive(), "server did not shut down"
