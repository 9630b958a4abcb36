"""Timing helpers on a CUDA card, shared by ``chip_smoke.py`` and
``scripts/profile_torch_step.py``."""
from __future__ import annotations

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
