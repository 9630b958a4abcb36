#!/usr/bin/env python3
"""chip_smoke.py's slice-17 phases alone on a CUDA card, in one fresh
process: where the time of a path-traced frame goes, then phases 53-56.

    python scripts/chip_slice17.py

Prints, beside the card's name and power limit: a torch.profiler summary of
one rt-fast frame of PickCube-v1's human camera at 16 envs and 128x128
(launches, syncs, host-to-device copies, device kernel ms, the device's idle
share) with its top kernels by device time; then what chip_smoke.py's
``rt_phase``, ``render_modes_phase``, ``bench_render_phase`` and
``slice17_worker`` print (the rt frames, the render modes @1024,
``bench_render`` at its defaults, the viewer, ``gpu_sim`` and the demos),
and the kernel times of the workers' frames.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import torch

    import chip_smoke as cs
    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make
    from maniskill_tpu_torch.physics.kinematics import geom_poses
    from maniskill_tpu_torch.render import tiled_rasterizer as tr
    from maniskill_tpu_torch.render.rasterizer import tiled_inputs
    from maniskill_tpu_torch.utils.timing import profile_calls

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    card = f"[{smi}]"
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    dev = torch.device("cuda")
    tr.build_kernels()
    paths = {}
    t0 = time.perf_counter()
    env = make("PickCube-v1", num_envs=16, obs_mode="state", device=dev,
               human_render_camera_configs=dict(width=128, height=128, shader_pack="rt-fast"))
    env.reset(seed=0)
    cam = env.unwrapped._human_render_cameras["render_camera"]
    cam.capture()
    _, prof = profile_calls(lambda: cam.capture(), 1)
    print({k: v for k, v in prof.items() if k != "top_kernels_ms"}, card)
    for k, v in prof["top_kernels_ms"].items():
        print(f"  {v:9.3f} ms  {k}")
    del env, cam
    cs.rt_phase(torch, dev, make, card)
    print(f"[{time.perf_counter() - t0:.1f} s] phase 53", flush=True)
    cs.render_modes_phase(torch, dev, make, card, tr, tiled_inputs, geom_poses, paths)
    cs.bench_render_phase(torch, card, tr, tiled_inputs, geom_poses, paths)
    print(f"[{time.perf_counter() - t0:.1f} s] phases 54's render modes and 55's bench_render", flush=True)
    seconds, kernel_paths = cs.slice17_worker(card)
    print(seconds, {k: v[0] for k, v in kernel_paths.items()})
    for name, (launches, inputs, H, W) in kernel_paths.items():
        times = cs.raster_times(tr, [x.to(dev) if isinstance(x, torch.Tensor) else x for x in inputs], H, W)
        print(name, launches, times, card)
    for k, v in paths.items():
        print(k, v)
    print(f"[{time.perf_counter() - t0:.1f} s] done", flush=True)


if __name__ == "__main__":
    main()
