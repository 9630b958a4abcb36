"""Render throughput benchmark (counterpart of
maniskill_tpu/examples/benchmarking/bench_render.py): CartpoleBalanceBenchmark-v1
rgb, zero actions, frames per second through the tiled rasterizer (its CUDA
kernel on the card), against the reference's RTX 4090 table: 128x128 @1024
envs = 32,138 fps (BASELINE.md).

Runs on the card; ``--device cpu`` runs on the CPU.

Usage: python -m maniskill_tpu_torch.examples.benchmarking.bench_render [-n 1024]
"""
from __future__ import annotations

import argparse
import json
import time

BASELINE_FPS = 32138.0  # RTX 4090, 128x128 @1024 envs


def main(argv=None):
    """Prints one JSON line; returns it as a dict, with the env."""
    p = argparse.ArgumentParser()
    p.add_argument("-n", "--num-envs", type=int, default=1024)
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--height", type=int, default=128)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--obs-mode", default="rgb")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from ... import envs  # noqa: F401 (registers the tasks)
    from ...utils.registration import make

    env = make(
        "CartpoleBalanceBenchmark-v1",
        num_envs=args.num_envs,
        obs_mode=args.obs_mode,
        sensor_configs=dict(width=args.width, height=args.height),
        device=args.device,
    )
    base = env.unwrapped
    env.reset(seed=0)
    act = torch.zeros((args.num_envs,) + base.single_action_space.shape, device=base.device)
    cuda = base.device.type == "cuda"

    obs, *_ = env.step(act)  # warm-up
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        obs, *_ = env.step(act)
    if cuda:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    fps = args.num_envs * args.steps / dt
    result = dict(
        metric=f"cartpole_{args.obs_mode}_{args.width}x{args.height}_fps",
        value=round(fps, 1),
        unit="env*frames/s",
        vs_baseline=round(fps / BASELINE_FPS, 3),
    )
    print(json.dumps(result))
    return dict(result, env=env, obs=obs)


if __name__ == "__main__":
    main()
