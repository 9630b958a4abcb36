"""Spans around the program's calls and the reading of a profiler trace.

During a traced stretch the harness wraps a few of the program's functions
in ``torch.profiler.record_function`` spans at run time (the program is not
edited), runs the stretch under ``torch.profiler`` with the CPU and CUDA
activities, exports the trace as Chrome JSON under the run's temporary
directory, and reduces it to records the per-layer metric readers take:
the device intervals, the launches by span and the device time under each
span. A kernel belongs to a span when the host call that launched it (same
correlation id) ran on the span's thread inside the span.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import tempfile
from typing import Dict, List, Tuple

import torch

# the program's calls that get a span: (module, attribute, span name)
SPANS = (
    ("maniskill_tpu_torch.physics", "step", "physics.step"),
    ("maniskill_tpu_torch.sensors.camera:Camera", "get_obs", "camera.get_obs"),
    ("maniskill_tpu_torch.render.rasterizer", "rasterize_tiles", "raster.rasterize_tiles"),
    ("maniskill_tpu_torch.parallel.train:PPOTrainer", "rollout", "ppo.rollout"),
    ("maniskill_tpu_torch.parallel.train:PPOTrainer", "update", "ppo.update"),
)
OWN_SPANS = {name for _, _, name in SPANS} | {"simbench.window", "simbench.step"}
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
            "cudaLaunchCooperativeKernel")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _resolve(path: str):
    import importlib

    mod, _, cls = path.partition(":")
    obj = importlib.import_module(mod)
    return getattr(obj, cls) if cls else obj


class Tracer:
    def __init__(self, tmpdir: str):
        self.tmpdir = tmpdir
        self.calls: Dict[str, List] = {}  # span name -> captured arguments
        self.events = None

    @contextlib.contextmanager
    def _spans(self):
        undo = []
        for path, attr, name in SPANS:
            try:
                owner = _resolve(path)
            except ImportError:
                continue
            fn = owner.__dict__.get(attr) if isinstance(owner, type) else getattr(owner, attr, None)
            if fn is None:
                continue

            def wrapped(*args, __fn=fn, __name=name, **kwargs):
                if __name == "raster.rasterize_tiles":
                    # the stage's inputs, for its bound (read after the trace)
                    self.calls.setdefault(__name, []).append(args[:8])
                with torch.profiler.record_function(__name):
                    return __fn(*args, **kwargs)

            setattr(owner, attr, functools.wraps(fn)(wrapped))
            undo.append((owner, attr, fn))
        try:
            yield
        finally:
            for owner, attr, fn in undo:
                setattr(owner, attr, fn)

    @contextlib.contextmanager
    def profile(self):
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        if cuda:
            torch.cuda.synchronize()
        with self._spans(), profile(activities=[ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda) as prof:
            with torch.profiler.record_function("simbench.window"):
                yield
                if cuda:
                    torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".json", dir=self.tmpdir)
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f)
        finally:
            os.remove(path)

    def records(self, steps: int) -> Dict:
        """The traced stretch reduced for the metric readers."""
        return reduce_trace(self.events, steps, self.calls)


def merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """A set of (start, end) intervals as disjoint ones: the busy time is
    their summed length, where overlaps count once (a sum of the intervals
    would count them twice)."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce_trace(trace, steps: int, calls: Dict) -> Dict:
    """Chrome-trace events (times in us) to seconds and counts:
    ``window`` (start, end) of the stretch, ``busy_s`` (union of device
    intervals inside it), ``device`` [(start, end, name)], ``spans``
    {name: [(start, end)]}, ``span_device_s`` {name: s of device time
    launched inside the spans}, ``span_launches`` {name: launches},
    ``idle_by_span`` {name: s of idle device time while that span was the
    innermost open one on the host}, ``steps`` and ``calls``."""
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    annotations, launches, device = [], {}, []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat == "user_annotation":
            annotations.append((ts, ts + dur, ev["name"], ev.get("tid")))
        elif cat in ("cuda_runtime", "cuda_driver") and ev["name"] in LAUNCHES:
            corr = (ev.get("args") or {}).get("correlation")
            launches[corr] = (ts, ev.get("tid"))
        elif cat in DEVICE_CATS:
            corr = (ev.get("args") or {}).get("correlation")
            device.append((ts, ts + dur, ev["name"], corr))
    window = [a for a in annotations if a[2] == "simbench.window"]
    if not window:
        return {}
    w0, w1 = window[0][0], window[0][1]
    device = [(max(s, w0), min(e, w1), n, c) for s, e, n, c in device if e > w0 and s < w1]
    spans: Dict[str, List[Tuple[float, float, object]]] = {}
    for s, e, name, tid in annotations:
        spans.setdefault(name, []).append((s, e, tid))

    def inside(name, ts, tid):
        return any(s <= ts <= e and t == tid for s, e, t in spans.get(name, ()))

    # only the harness's own spans are read (the profiler adds its own, such
    # as one per optimizer step, which nothing reads)
    ours = [name for name in spans if name in OWN_SPANS]
    span_launches = {name: sum(1 for ts, tid in launches.values() if inside(name, ts, tid)) for name in ours}
    span_device = {}
    for name in ours:
        span_device[name] = sum(
            e - s for s, e, _, c in device if c in launches and inside(name, *launches[c])
        ) / 1e6

    # idle device time, each gap named by the innermost span open on the host
    busy = merged([(s, e) for s, e, _, _ in device])
    gaps, cur = [], w0
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if w1 > cur:
        gaps.append((cur, w1))
    inner = sorted(((s, e, n) for s, e, n, _ in annotations if n != "simbench.window"),
                   key=lambda x: x[1] - x[0])
    idle_by_span: Dict[str, float] = {}
    for gs, ge in gaps:
        mid = 0.5 * (gs + ge)
        label = next((n for s, e, n in inner if s <= mid <= e), "outside spans")
        idle_by_span[label] = idle_by_span.get(label, 0.0) + (ge - gs) / 1e6

    by_kernel: Dict[str, float] = {}
    for s, e, n, _ in device:
        by_kernel[n[:120]] = by_kernel.get(n[:120], 0.0) + (e - s) / 1e6
    return dict(
        window=((w0 / 1e6), (w1 / 1e6)),
        window_s=(w1 - w0) / 1e6,
        busy_s=sum(e - s for s, e in busy) / 1e6,
        device_by_name=by_kernel,
        spans={k: [(s / 1e6, e / 1e6) for s, e, _ in v] for k, v in spans.items()},
        span_device_s=span_device,
        span_launches=span_launches,
        idle_by_span=idle_by_span,
        steps=steps,
        calls=calls,
    )


def breakdown(rec: Dict) -> Dict:
    """The ten device operations that took most time, and the idle time by
    what the host was doing, in seconds."""
    ops = sorted(rec.get("device_by_name", {}).items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(rec.get("idle_by_span", {}).items(), key=lambda kv: -kv[1])[:10]
    return dict(device_ops=[[k, v] for k, v in ops], idle_gaps=[[f"idle in {k}", v] for k, v in gaps])
