#!/usr/bin/env python3
"""chip_smoke.py's slice-18 phases alone on a CUDA card, in one fresh
process: where a Sim2RealEnv step's time goes, then phases 57-59.

    python scripts/chip_slice18.py

Prints, beside the card's name and power limit: a torch.profiler summary of
one sim2real step and of one sim reset of SO100GraspCube-v1 rgb at one env
(launches, syncs, copies, device kernel ms, the device's idle share), the
sync alone; then what chip_smoke.py's ``sim2real_phase``,
``sharded_ppo_phase`` and ``assets_phase`` print, and the kernel path's
numbers.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import torch

    import chip_smoke as cs
    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make
    from maniskill_tpu_torch.agents.robots.lerobot import LeRobotRealAgent
    from maniskill_tpu_torch.envs.sim2real_env import Sim2RealEnv
    from maniskill_tpu_torch.physics.kinematics import geom_poses
    from maniskill_tpu_torch.render import tiled_rasterizer as tr
    from maniskill_tpu_torch.render.rasterizer import tiled_inputs
    from maniskill_tpu_torch.utils.timing import profile_calls
    from maniskill_tpu_torch.wrappers.flatten import FlattenRGBDObservationWrapper

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    card = f"[{smi}]"
    print(smi, torch.__version__, torch.version.cuda, flush=True)
    dev = torch.device("cuda")
    tr.build_kernels()
    t0 = time.perf_counter()
    sim = FlattenRGBDObservationWrapper(make(cs.SIM2REAL[0], num_envs=1, obs_mode="rgb", device=dev), rgb=True,
                                        depth=False, state=True)
    base = sim.unwrapped
    offsets = np.array([0, 0, 6.8, 0, 0, 0])
    stub = cs.StubFollower(np.rad2deg(base.agent.robot.qpos[0].cpu().numpy()) + offsets)

    def reset_fn(env, seed=None, options=None):
        env.sim_env.reset(seed=seed, options=options)
        env.agent.reset(env.base_sim_env.agent.robot.qpos.cpu().numpy().reshape(-1))

    env = Sim2RealEnv(sim, LeRobotRealAgent(stub), real_reset_function=reset_fn)
    env.reset(seed=0)
    zero = np.zeros(base.single_action_space.shape, np.float32)
    env.step(zero)
    for name, fn in (("sim2real step (20 Hz pacing included)", lambda: env.step(zero)),
                     ("sim reset (renders the camera)", lambda: sim.reset(seed=1)),
                     ("_sync_sim_from_real", env._sync_sim_from_real)):
        _, prof = profile_calls(fn, 1)
        print(name, {k: (round(v, 4) if isinstance(v, float) else v) for k, v in prof.items()
                     if k != "top_kernels_ms"}, card, flush=True)
    del env, sim, base
    print(f"[{time.perf_counter() - t0:.1f} s] profiles", flush=True)
    paths = {}
    cs.sim2real_phase(torch, dev, make, card, tr, tiled_inputs, geom_poses, paths)
    print(f"[{time.perf_counter() - t0:.1f} s] phase 57", flush=True)
    cs.sharded_ppo_phase(torch, dev, card)
    print(f"[{time.perf_counter() - t0:.1f} s] phase 58", flush=True)
    cs.assets_phase(card)
    print(f"[{time.perf_counter() - t0:.1f} s] phase 59", flush=True)
    for k, v in paths.items():
        print(k, v)


if __name__ == "__main__":
    main()
