"""PickSingleYCB-v1 statics on the CPU, in the JAX package or the PyTorch
port: from the port's reset (seed 0) at NUM_ENVS (64) envs, 20 zero-action
``pd_joint_delta_pos`` steps; then per model id the largest relative error
of the table's vertical force on the object against its weight, and the
object's largest displacement:

    JAX_PLATFORMS=cpu python scripts/ycb_statics.py jax
    python scripts/ycb_statics.py torch

Both packages start from the same states (the port's, handed to the JAX env
through ``reset_to_env_states``); the JAX contact solver runs with its bf16
cast made an identity (``f32_solver`` in tests/test_torch_common.py).
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

NUM_ENVS, STEPS = 64, 20


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("package", choices=("jax", "torch"))
    args = p.parse_args(argv)
    import torch

    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make as tmake

    B = NUM_ENVS
    kw = dict(num_envs=B, obs_mode="state", control_mode="pd_joint_delta_pos")
    te = tmake("PickSingleYCB-v1", device="cpu", **kw)
    te.reset(seed=0)
    model_ids = te.unwrapped.model_ids
    solver = contextlib.nullcontext()
    if args.package == "jax":
        import maniskill_tpu.envs  # noqa: F401
        from maniskill_tpu.utils.registration import make as jmake
        from test_torch_common import f32_solver, tree

        solver = f32_solver()
    with solver:
        if args.package == "jax":
            state = tree(te.unwrapped.get_state_dict(), lambda v: v.numpy())
            env = jmake("PickSingleYCB-v1", **kw)
            env.reset(seed=0, options=dict(reset_to_env_states=state))
            zero = np.zeros((B, 8), np.float32)
        else:
            env, zero = te, torch.zeros(B, 8)
        base = env.unwrapped
        assert list(base.model_ids) == list(model_ids)
        p0 = np.array(base.obj.pose.p)
        for _ in range(STEPS):
            env.step(zero)
        force = np.array(base.scene.get_pairwise_contact_forces(base.table_scene.table, base.obj))[:, 2]
        weight = np.array(base.scene.model.body_mass)[:, base.obj.body_id] * 9.81
        moved = np.linalg.norm(np.array(base.obj.pose.p) - p0, axis=-1)
    rel = np.abs(force - weight) / weight
    for m in np.unique(model_ids):
        sel = model_ids == m
        print(f"{args.package} PickSingleYCB-v1 x{B} seed 0, {STEPS} steps: {m} in {int(sel.sum())} envs: "
              f"table force vs weight rel err max {rel[sel].max():.6f}, displacement max "
              f"{moved[sel].max() * 1e3:.6f} mm", flush=True)


if __name__ == "__main__":
    main()
