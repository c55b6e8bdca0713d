"""Shared-memory tethered-mode tests (runtime/visor.py): rotating
frame buffers over POSIX shm, bounded frame-queue back-pressure, the
spec_t timing pipeline, bad-job resilience, shutdown. Uses an injected
render_fn - the reference tests visor against a dummy render process
the same way (visor.h:386-388)."""

import threading
import time

import numpy as np
import pytest

from envutil.runtime import visor


def _start_server(render_fn, tmp_path, **kw):
    sock = str(tmp_path / "visor.sock")
    srv = visor.VisorServer(render_fn, sock, width=64, height=32,
                            shm_prefix=f"eutest_{tmp_path.name}", **kw)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    for _ in range(200):
        if (tmp_path / "visor.sock").exists():
            break
        time.sleep(0.02)
    return srv, th, sock


def _checker(spec):
    """Render a frame whose pixels encode the serial_no."""
    s = int(spec["serial_no"])
    return np.full((32, 64), s, np.uint32)


def test_visor_frames_and_timing(tmp_path):
    srv, th, sock = _start_server(_checker, tmp_path)
    cl = visor.VisorClient(sock)
    assert cl.hello["nframes"] == visor.NFRAMES
    for i in range(1, 8):
        cl.submit({"width": 64, "height": 32})
    seen = []
    for i in range(1, 8):
        hdr, px = cl.next_frame()
        assert px.shape == (32, 64)
        assert int(px[0, 0]) == hdr["serial_no"]
        seen.append(hdr["serial_no"])
        # timing pipeline is monotone through the stages present
        stamps = [hdr[k] for k in visor.TIMING_STAGES if k in hdr]
        assert len(stamps) >= 5
        assert all(b >= a for a, b in zip(stamps, stamps[1:]))
        assert visor.print_timing(hdr)  # formats without error
    assert seen == list(range(1, 8))
    cl.shutdown()
    th.join(timeout=10)
    assert not th.is_alive()
    cl.close()


def test_visor_back_pressure(tmp_path):
    """The render thread may run at most FRAME_QUEUE_DEPTH frames
    ahead of the consumer (visor.h:608)."""
    rendered = []

    def slow_count(spec):
        rendered.append(spec["serial_no"])
        return np.zeros((32, 64), np.uint32)

    srv, th, sock = _start_server(slow_count, tmp_path)
    cl = visor.VisorClient(sock)
    for _ in range(10):
        cl.submit({})
    time.sleep(1.0)  # let the server run ahead as far as it's allowed
    assert len(rendered) <= visor.FRAME_QUEUE_DEPTH
    # consuming frames releases slots; everything drains
    for _ in range(10):
        cl.next_frame()
    assert len(rendered) == 10
    cl.shutdown()
    th.join(timeout=10)
    cl.close()


def test_visor_bad_job_keeps_serving(tmp_path):
    def flaky(spec):
        if spec.get("boom"):
            raise ValueError("no such facet")
        return np.ones((32, 64), np.uint32)

    srv, th, sock = _start_server(flaky, tmp_path)
    cl = visor.VisorClient(sock)
    cl.submit({"boom": True})
    with pytest.raises(RuntimeError, match="no such facet"):
        cl.next_frame()
    cl.submit({})
    hdr, px = cl.next_frame()
    assert px[0, 0] == 1
    cl.shutdown()
    th.join(timeout=10)
    cl.close()


def test_visor_buffer_rotation(tmp_path):
    """Buffers come from a free stack of NFRAMES and are reused only
    after release (store_t semantics, visor.h:177-228)."""
    srv, th, sock = _start_server(_checker, tmp_path)
    cl = visor.VisorClient(sock)
    used = set()
    for i in range(visor.NFRAMES * 3):
        cl.submit({})
        hdr, _px = cl.next_frame()
        used.add(hdr["buffer"])
    assert used <= set(range(visor.NFRAMES))
    cl.shutdown()
    th.join(timeout=10)
    cl.close()
