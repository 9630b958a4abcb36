"""The port's browser viewer (maniskill_tpu_torch/viewer) and
``interactive_panda --browser``, on an ephemeral localhost port.

- A frame pushed and read back through ``/stream`` decodes with Pillow to
  the same shape at PSNR >= 30 dB (quality 85); an event posted to
  ``/api/event`` comes back from ``poll_events``; ``/api/status`` and the
  page are served.
- The port's baseline JPEG encoder (``viewer/jpeg.py``, numpy, no Pillow)
  writes the quantization and Huffman tables libjpeg writes through Pillow
  at the same quality (Annex K, scaled as libjpeg scales them), and Pillow
  decodes its files.
- The browser loop's event-to-action mapping equals the JAX package's: both
  loops run over one scripted event list against a stand-in env and viewer
  (pytest's MonkeyPatch), and record the same actions.
- ``interactive_panda --browser 0`` on PickCube-v1 at one env on the CPU,
  driven by events posted over HTTP while it runs: the TCP follows +x.
"""
import io
import json
import threading
import time
import types
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

import maniskill_tpu.utils.registration as jregistration
import maniskill_tpu.viewer as jviewer
from maniskill_tpu.examples.teleoperation import interactive_panda as jpanda

import maniskill_tpu_torch.utils.registration as tregistration
import maniskill_tpu_torch.viewer as tviewer
from maniskill_tpu_torch.examples.teleoperation import interactive_panda as tpanda
from maniskill_tpu_torch.viewer import BrowserViewer
from maniskill_tpu_torch.viewer.jpeg import encode_jpeg

from test_torch_common import one_torch_thread  # noqa: F401

HOST = "127.0.0.1"


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def read_stream_frame(port):
    with urllib.request.urlopen(f"http://{HOST}:{port}/stream", timeout=30) as r:
        assert r.headers["Content-Type"] == "multipart/x-mixed-replace; boundary=f"
        assert r.readline() == b"--f\r\n"
        assert r.readline() == b"Content-Type: image/jpeg\r\n"
        n = int(r.readline().split(b":")[1])
        assert r.readline() == b"\r\n"
        return r.read(n)


def post_event(port, ev):
    req = urllib.request.Request(f"http://{HOST}:{port}/api/event", data=json.dumps(ev).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status


def scene_image():
    """A 96x128 frame with flat regions, edges and a gradient."""
    y, x = np.mgrid[0:96, 0:128]
    img = np.stack([x * 2, y * 2, (x + y) % 64 * 4], -1).astype(np.uint8)
    img[20:60, 30:90] = (200, 30, 30)
    img[70:90, 10:40] = (20, 160, 240)
    return img


def test_stream_event_status_roundtrip():
    viewer = BrowserViewer(port=0, host=HOST, quality=85)
    try:
        img = scene_image()
        viewer.push_frame(torch.as_tensor(img))  # a tensor is read back to the host
        decoded = np.asarray(Image.open(io.BytesIO(read_stream_frame(viewer.port))).convert("RGB"))
        assert decoded.shape == img.shape
        assert psnr(decoded, img) >= 30.0, psnr(decoded, img)

        assert post_event(viewer.port, {"type": "key", "key": "w"}) == 204
        assert post_event(viewer.port, {"type": "drag", "dx": 0.1, "dy": -0.2}) == 204
        assert viewer.poll_events() == [{"type": "key", "key": "w"}, {"type": "drag", "dx": 0.1, "dy": -0.2}]
        assert viewer.poll_events() == []

        viewer.set_status({"step": 3, "success": False})
        with urllib.request.urlopen(f"http://{HOST}:{viewer.port}/api/status", timeout=30) as r:
            assert json.loads(r.read()) == {"step": 3, "success": False}
        with urllib.request.urlopen(f"http://{HOST}:{viewer.port}/", timeout=30) as r:
            assert b'<img id="frame" src="/stream"' in r.read()
    finally:
        viewer.close()


def _segments(jpeg: bytes):
    """(marker, payload) of the segments up to the scan header."""
    out, pos = [], 2
    while True:
        marker, length = int.from_bytes(jpeg[pos:pos + 2], "big"), int.from_bytes(jpeg[pos + 2:pos + 4], "big")
        out.append((marker, jpeg[pos + 4:pos + 2 + length]))
        if marker == 0xFFDA:
            return out
        pos += 2 + length


@pytest.mark.parametrize("quality", [30, 85, 95])
def test_jpeg_tables_match_libjpeg(quality):
    img = scene_image()
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=quality, subsampling=0, optimize=False)
    ours = encode_jpeg(img, quality)
    ref_seg, our_seg = _segments(buf.getvalue()), _segments(ours)
    for marker in (0xFFDB, 0xFFC4):  # DQT, DHT: each table in its own segment or several in one
        ref = b"".join(p for m, p in ref_seg if m == marker)
        got = b"".join(p for m, p in our_seg if m == marker)
        assert sorted(_tables(ref, marker)) == sorted(_tables(got, marker)), hex(marker)
    decoded = np.asarray(Image.open(io.BytesIO(ours)).convert("RGB"))
    libjpeg = np.asarray(Image.open(buf).convert("RGB"))
    assert psnr(decoded, img) >= psnr(libjpeg, img) - 0.5, (psnr(decoded, img), psnr(libjpeg, img))


def _tables(payload: bytes, marker: int):
    out, pos = [], 0
    while pos < len(payload):
        if marker == 0xFFDB:
            out.append(payload[pos:pos + 65])
            pos += 65
        else:
            n = 17 + sum(payload[pos + 1:pos + 17])
            out.append(payload[pos:pos + n])
            pos += n
    return out


def test_jpeg_odd_sizes_and_noise():
    rng = np.random.default_rng(0)
    for shape in ((1, 1, 3), (9, 17, 3), (33, 8, 3)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        decoded = np.asarray(Image.open(io.BytesIO(encode_jpeg(img, 100))).convert("RGB"))
        assert decoded.shape == shape
        assert psnr(decoded, img) >= 30.0


class _Agent:
    def __init__(self):
        self.tcp = types.SimpleNamespace(pose=types.SimpleNamespace(p=torch.zeros(1, 3)))


class _StandInEnv:
    """Records the actions a browser loop sends."""

    def __init__(self, log):
        self.log = log
        self.unwrapped = types.SimpleNamespace(agent=_Agent())

    def reset(self, seed=None, options=None):
        self.log.append(("reset", seed))

    def step(self, action):
        self.log.append(("step", np.asarray(action, np.float32).copy()))
        return {}, torch.zeros(1), torch.zeros(1, dtype=torch.bool), torch.zeros(1, dtype=torch.bool), {}

    def render(self):
        return torch.zeros(1, 4, 4, 3, dtype=torch.uint8)

    def close(self):
        pass


class _StandInViewer:
    script = []

    def __init__(self, port=8400, host="0.0.0.0", quality=85):
        self.port = port
        self._events = [list(e) for e in self.script]

    def poll_events(self):
        return self._events.pop(0) if self._events else [{"type": "key", "key": "q"}]

    def push_frame(self, rgb):
        pass

    def set_status(self, status):
        pass

    def close(self):
        pass


SCRIPT = [
    [{"type": "key", "key": "w"}],
    [{"type": "key", "key": "w"}, {"type": "key", "key": "a"}],
    [{"type": "drag", "dx": 0.1, "dy": -0.25}],
    [],
    [{"type": "wheel", "dz": 1}],
    [{"type": "key", "key": "g"}],
    [{"type": "key", "key": "r"}, {"type": "key", "key": "r"}, {"type": "key", "key": "d"}],
    [{"type": "key", "key": "x"}],
    [{"type": "key", "key": "z"}],
    [{"type": "drag", "dx": -2.0, "dy": 0.0}, {"type": "key", "key": "f"}],
]


def test_browser_mapping_matches_reference(monkeypatch):
    logs = {}
    monkeypatch.setattr(_StandInViewer, "script", SCRIPT)
    for name, reg, view, panda in (("jax", jregistration, jviewer, jpanda), ("port", tregistration, tviewer, tpanda)):
        log = logs[name] = []
        monkeypatch.setattr(reg, "make", lambda *a, **k: _StandInEnv(log))
        monkeypatch.setattr(view, "BrowserViewer", _StandInViewer)
        argv = ["--env-id", "PickCube-v1", "--browser", "0", "--speed", "0.5"]
        panda.main(argv + (["--device", "cpu"] if name == "port" else []))
    ref, got = logs["jax"], logs["port"]
    assert [e[0] for e in got] == [e[0] for e in ref] and len(ref) > 8
    for (kind, a), (_, b) in zip(got, ref):
        if kind == "step":
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def test_interactive_panda_browser_drives_the_arm(tmp_path):
    """The real loop on the CPU: 'w' events posted while it runs move the
    TCP along +x; the stream serves the human camera's frames; the episode
    is recorded as a trajectory."""
    frames = []

    def drive(viewer):
        def post():
            frames.append(read_stream_frame(viewer.port))
            for _ in range(3):
                post_event(viewer.port, {"type": "key", "key": "w"})
                time.sleep(0.3)
            post_event(viewer.port, {"type": "key", "key": "q"})

        threading.Thread(target=post, daemon=True).start()

    out = tpanda.main(["--env-id", "PickCube-v1", "--browser", "0", "--device", "cpu",
                       "--max-steps", "3", "--record-dir", str(tmp_path)], on_start=drive)
    tcp = out["tcp"]
    assert 1 <= len(tcp) <= 3
    assert tcp[-1][0] - out["tcp0"][0] > 0.005, (out["tcp0"], tcp)  # forward along +x
    assert frames and Image.open(io.BytesIO(frames[0])).size == (512, 512)
    assert sorted(p.suffix for p in tmp_path.iterdir()) == [".h5", ".json"]
