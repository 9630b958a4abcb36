"""PickClutterYCB-v1 contacts on the CPU, in the JAX package or the PyTorch
port, from the port's reset (seed 0) at 8 envs:

- after STEPS zero-action ``pd_joint_delta_pos`` steps, each env's
  ``contact.overflow`` (live contact candidates beyond the solver's top-K
  budget);
- from the reset's state with each env's second object set down on its
  first (STACK_OFFSET from the first's position), the contacts of
  ``physics.forward`` (kinematics and the narrowphase, no dynamics): each
  env's count of live hull-hull contact rows and the deepest of them (m).

    JAX_PLATFORMS=cpu python scripts/clutter_overflow.py jax
    python scripts/clutter_overflow.py torch

Both packages start from the same states (the port's, handed to the JAX env
through ``reset_to_env_states``); the JAX contact solver runs with its bf16
cast made an identity. ``chip_smoke.py`` holds the card to the JAX lines.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

NUM_ENVS, SEED, STEPS = 8, 0, 3
STACK_OFFSET = (0.02, 0.01, 0.06)
HULL, DEAD = 6, -1e5  # the HULL geom type; depth below DEAD is a dead row


def hull_hull_contacts(model, contact):
    """Per env: (live hull-hull rows, their deepest depth or -inf)."""
    gtype = np.array(model.geom_type)
    hh = (gtype[np.array(contact.geom1)] == HULL) & (gtype[np.array(contact.geom2)] == HULL)
    depth = np.array(contact.depth).astype(np.float32)[:, hh]
    live = depth > DEAD
    return live.sum(1), np.where(live, depth, -np.inf).max(1)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("package", choices=("jax", "torch"))
    args = p.parse_args(argv)
    import torch

    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make as tmake
    from maniskill_tpu_torch import physics as tphys

    kw = dict(num_envs=NUM_ENVS, obs_mode="state", control_mode="pd_joint_delta_pos")
    te = tmake("PickClutterYCB-v1", device="cpu", **kw)
    te.reset(seed=SEED)
    solver = contextlib.nullcontext()
    if args.package == "jax":
        import jax.numpy as jnp

        import maniskill_tpu.envs  # noqa: F401
        from maniskill_tpu import physics as jphys
        from maniskill_tpu.utils.registration import make as jmake
        from test_torch_common import f32_solver, tree

        solver = f32_solver()
    with solver:
        if args.package == "jax":
            state = tree(te.unwrapped.get_state_dict(), lambda v: v.numpy())
            extras = state.pop("extras")
            env = jmake("PickClutterYCB-v1", **kw)
            env.reset(seed=SEED, options=dict(reset_to_env_states=state))
            base = env.unwrapped
            base.scene.set_extra("target_idx", extras["target_idx"], masked=False)
            zero = np.zeros((NUM_ENVS, 8), np.float32)
            forward, as_array = jphys.forward, jnp.asarray
        else:
            env, zero = te, torch.zeros(NUM_ENVS, 8)
            base = env.unwrapped
            forward, as_array = tphys.forward, torch.as_tensor
        model, data = base.scene.model, base.scene.data
        qpos = np.array(data.qpos).astype(np.float32)
        a0, a1 = (int(np.array(model.body_q_adr)[o.body_id]) for o in base.objs[:2])
        qpos[:, a1:a1 + 3] = qpos[:, a0:a0 + 3] + np.float32(STACK_OFFSET)
        stacked = forward(model, data.replace(qpos=as_array(qpos)))
        n_rows, deepest = hull_hull_contacts(model, stacked.contact)
        for _ in range(STEPS):
            env.step(zero)
        overflow = np.array(env.unwrapped.scene.data.contact.overflow)
    print(f"{args.package} PickClutterYCB-v1 x{NUM_ENVS} seed {SEED}, {STEPS} steps: overflow per env "
          f"{overflow.tolist()}", flush=True)
    print(f"{args.package} PickClutterYCB-v1 x{NUM_ENVS} seed {SEED}, second object at the first's "
          f"+{list(STACK_OFFSET)}: live hull-hull contact rows per env {n_rows.tolist()}, deepest per env (m) "
          f"{[float(f'{d:.7g}') for d in deepest]}", flush=True)


if __name__ == "__main__":
    main()
