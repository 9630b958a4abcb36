"""Timing helpers on a CUDA card, shared by ``chip_smoke.py`` and
``scripts/profile_torch_step.py``."""
from __future__ import annotations

import collections
import time

import torch


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls after one warm-up call, timed
    with CUDA events around the whole run."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_steps(env, action, n: int) -> float:
    """Seconds for ``n`` env.step calls on the host clock, synchronized at
    both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        env.step(action)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profile_calls(fn, n: int, cpu_ops: bool = False):
    """Run ``fn()`` ``n`` times under torch.profiler. Returns (profiler,
    per-call summary): kernel launches, the device's kernel records, stream
    and event syncs (the window's own closing device sync is neither),
    memcpy calls, host-to-device copies, device kernel ms, host ms and the
    device's idle share.

    Launches and syncs are host-side records; kernel records, copies and
    device ms are device-side records, of which the profiler now and then
    loses a run: kernel records then fall short of launches
    (``scripts/profiler_record_loss.py`` counts how often).

    The CUDA activity alone records the runtime calls and the device work
    these counts read; ``cpu_ops`` adds the torch operators (for a table or
    trace by operator), which costs the profiler ~15 s more to read per
    step of ~25,000 launches (H100 80GB HBM3, 700 W)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if cpu_ops else [ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    def count(*names):
        return sum(e.count for e in events if e.key in names)

    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and not e.key.startswith(("Memcpy", "Memset"))]
    device_ms = sum(device_us(e) for e in kernels) / 1e3
    summary = dict(
        launches=count("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC") / n,
        kernel_records=sum(e.count for e in kernels) / n,
        syncs=count("cudaStreamSynchronize", "cudaEventSynchronize") / n,
        memcpy=count("cudaMemcpyAsync", "cudaMemcpy") / n,
        h2d_copies=sum(e.count for e in events if e.key.startswith("Memcpy HtoD")) / n,
        device_kernel_ms=device_ms / n,
        wall_ms=wall_ms / n,
        device_idle_share=1.0 - device_ms / wall_ms if wall_ms > 0 else None,
    )
    # kernels whose names share their first 80 characters add up under one key
    top = collections.Counter()
    for e in kernels:
        top[e.key[:80]] += device_us(e) / 1e3 / n
    summary["top_kernels_ms"] = dict(top.most_common(15))
    return prof, summary


def device_us(event) -> float:
    """A profiler event's own device time in us (the attribute's name
    differs between torch versions)."""
    return getattr(event, "self_device_time_total", None) or getattr(event, "self_cuda_time_total", 0)
