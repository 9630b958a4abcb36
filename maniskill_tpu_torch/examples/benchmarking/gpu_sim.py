"""Simulation benchmark CLI (counterpart of
maniskill_tpu/examples/benchmarking/gpu_sim.py): times ``env.step`` with zero
actions and ``env.reset``, and can append the rates to a CSV.

Runs on the card; ``--device cpu`` runs on the CPU (no card is chosen
quietly: without CUDA the default raises).

Usage:
    python -m maniskill_tpu_torch.examples.benchmarking.gpu_sim \\
        -e PushCube-v1 -n 1024 --obs-mode state [--save-results rates.csv]
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-e", "--env-id", default="PushCube-v1")
    p.add_argument("-n", "--num-envs", type=int, default=1024)
    p.add_argument("--obs-mode", default="state")
    p.add_argument("--control-mode", default="pd_joint_delta_pos")
    p.add_argument("--num-steps", type=int, default=200)
    p.add_argument("--sim-freq", type=int, default=120)
    p.add_argument("--control-freq", type=int, default=60)
    p.add_argument("--save-results", default=None, help="CSV path")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Returns the profiler (its ``stats`` hold the rates) and the env."""
    args = parse_args(argv)

    import torch

    from ... import envs  # noqa: F401 (registers the tasks)
    from ...utils.registration import make
    from .profiling import Profiler

    env = make(
        args.env_id,
        num_envs=args.num_envs,
        obs_mode=args.obs_mode,
        control_mode=args.control_mode,
        sim_config=dict(sim_freq=args.sim_freq, control_freq=args.control_freq),
        device=args.device,
    )
    base = env.unwrapped
    base.print_sim_details()
    env.reset(seed=0)
    act = torch.zeros((args.num_envs,) + base.single_action_space.shape, device=base.device)
    sync = torch.cuda.synchronize if base.device.type == "cuda" else None
    profiler = Profiler(synchronize_fn=sync)

    env.step(act)  # warm-up
    with profiler.profile("env.step", total_steps=args.num_steps, num_envs=args.num_envs):
        for _ in range(args.num_steps):
            env.step(act)
    profiler.log_stats("env.step")

    with profiler.profile("env.reset", total_steps=10, num_envs=args.num_envs):
        for _ in range(10):
            env.reset()
    profiler.log_stats("env.reset")

    if args.save_results:
        profiler.update_csv(
            args.save_results,
            dict(
                env_id=args.env_id,
                num_envs=args.num_envs,
                obs_mode=args.obs_mode,
                control_mode=args.control_mode,
                sim_freq=args.sim_freq,
                control_freq=args.control_freq,
            ),
        )
    return dict(profiler=profiler, env=env)


if __name__ == "__main__":
    main()
