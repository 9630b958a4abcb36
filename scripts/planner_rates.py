"""Success rate of the batched motion planner's scripted solutions, in the
JAX package or in the PyTorch port, on one batch of 128 envs per task, on
the CPU:

    JAX_PLATFORMS=cpu python scripts/planner_rates.py jax [--f32-solver]
    python scripts/planner_rates.py torch

``--f32-solver`` runs the JAX package's contact solver with its bf16 matvec
cast made an identity (the arithmetic the port uses; ``f32_solver`` in
tests/test_torch_common.py). Prints one line per task: successes, envs,
rate, control steps and seconds.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

TASKS = ["PushCube-v1", "PickCube-v1", "PullCube-v1", "StackCube-v1", "PlaceSphere-v1",
         "StackPyramid-v1", "LiftPegUpright-v1", "PullCubeTool-v1", "PickSingleYCB-v1",
         "PegInsertionSide-v1", "PlugCharger-v1"]
NUM_ENVS = 128
SEED = 0


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("package", choices=("jax", "torch"))
    p.add_argument("--f32-solver", action="store_true", help="JAX only: the solver's bf16 cast made an identity")
    args = p.parse_args(argv)
    solver = contextlib.nullcontext()
    if args.package == "jax":
        import maniskill_tpu.envs  # noqa: F401
        from maniskill_tpu.examples.motionplanning.solutions import SOLUTIONS
        from maniskill_tpu.utils.registration import make

        if args.f32_solver:
            from test_torch_common import f32_solver

            solver = f32_solver()
        kw = {}
    else:
        import maniskill_tpu_torch.envs  # noqa: F401
        from maniskill_tpu_torch import make
        from maniskill_tpu_torch.examples.motionplanning.solutions import SOLUTIONS

        kw = dict(device="cpu")
    with solver:
        for uid in TASKS:
            env = make(uid, num_envs=NUM_ENVS, obs_mode="state", control_mode="pd_joint_pos", **kw)
            env.reset(seed=SEED)
            t0 = time.perf_counter()
            success = np.asarray(SOLUTIONS[uid](env)[-1]["success"].tolist())
            steps = int(np.asarray(env.unwrapped.elapsed_steps.tolist())[0])
            print(f"{args.package}{' f32 solver' if args.f32_solver else ''} {uid} x{NUM_ENVS} seed {SEED}: "
                  f"{int(success.sum())}/{len(success)} = {success.mean():.6f}, {steps} control steps, "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
