"""Profiler (counterpart of maniskill_tpu/examples/benchmarking/profiling.py).

Measures wall time per N steps -> env-steps/s and parallel steps/s, host
RSS and the card's peak allocated memory; appends CSV rows keyed by config,
in the reference's columns and order, so the port's numbers can sit beside
the JAX package's.
"""
from __future__ import annotations

import contextlib
import csv
import os
import time
from typing import Dict


def _host_rss_mb() -> float:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def _device_mem_mb() -> float:
    """Peak memory the card's allocator handed out, in MB (0 without CUDA)."""
    import torch

    if not torch.cuda.is_available():
        return 0.0
    return torch.cuda.max_memory_allocated() / 1e6


class Profiler:
    def __init__(self, output_format: str = "stdout", synchronize_fn=None):
        """``synchronize_fn``: called before and after each timed region
        (``torch.cuda.synchronize`` on the card)."""
        self.output_format = output_format
        self.stats: Dict[str, dict] = {}
        self.synchronize_fn = synchronize_fn

    def log(self, msg: str):
        print(msg, flush=True)

    @contextlib.contextmanager
    def profile(self, name: str, total_steps: int, num_envs: int):
        if self.synchronize_fn:
            self.synchronize_fn()
        start = time.perf_counter()
        yield
        if self.synchronize_fn:
            self.synchronize_fn()
        dt = time.perf_counter() - start
        self.stats[name] = dict(
            fps=total_steps * num_envs / dt,
            psps=total_steps / dt,  # parallel steps per second
            total_steps=total_steps,
            num_envs=num_envs,
            dt=dt,
            cpu_mem_mb=_host_rss_mb(),
            gpu_mem_mb=_device_mem_mb(),
        )

    def log_stats(self, name: str):
        s = self.stats[name]
        self.log(
            f"{name}: {s['fps']:,.1f} steps/s, {s['psps']:,.1f} parallel steps/s "
            f"({s['num_envs']} envs x {s['total_steps']} steps in {s['dt']:.2f}s), "
            f"host {s['cpu_mem_mb']:.0f}MB device {s['gpu_mem_mb']:.0f}MB"
        )

    @contextlib.contextmanager
    def trace(self, logdir: str):
        """A torch.profiler trace of the region (host operators and CUDA
        kernels), written to ``logdir`` as a Chrome trace JSON."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(logdir, exist_ok=True)
        with profile(activities=activities) as prof:
            yield
        path = os.path.join(logdir, "trace.json")
        prof.export_chrome_trace(path)
        self.log(f"torch.profiler trace written to {path}")

    def update_csv(self, csv_path: str, config: Dict):
        """Append a row keyed by the config columns, replacing a row with the
        same config; the columns: config, then ``{name}/fps`` and
        ``{name}/psps`` per profiled region, then cpu_mem_mb and gpu_mem_mb."""
        fieldnames = list(config.keys())
        for name in self.stats:
            fieldnames += [f"{name}/fps", f"{name}/psps"]
        fieldnames += ["cpu_mem_mb", "gpu_mem_mb"]
        fieldnames = list(dict.fromkeys(fieldnames))

        existing = []
        if os.path.exists(csv_path):
            with open(csv_path) as f:
                existing = list(csv.DictReader(f))

        row = dict(config)
        mem = dict(cpu_mem_mb=0.0, gpu_mem_mb=0.0)
        for name, s in self.stats.items():
            row[f"{name}/fps"] = round(s["fps"], 2)
            row[f"{name}/psps"] = round(s["psps"], 2)
            mem["cpu_mem_mb"] = max(mem["cpu_mem_mb"], s["cpu_mem_mb"])
            mem["gpu_mem_mb"] = max(mem["gpu_mem_mb"], s["gpu_mem_mb"])
        row.update({k: round(v, 1) for k, v in mem.items()})

        key = {k: str(v) for k, v in config.items()}
        out = [r for r in existing if {k: r.get(k, "") for k in key} != key]
        out.append({k: str(v) for k, v in row.items()})
        for r in out:
            for k in r:
                if k not in fieldnames:
                    fieldnames.append(k)
        with open(csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fieldnames)
            w.writeheader()
            w.writerows(out)
