"""Physical figures of the locomotion family on the CPU, in the JAX package
or the PyTorch port: for each of the 15 envs, from the port's reset (seed 0)
at NUM_ENVS (16) envs, STEPS (10) zero-action ``pd_joint_delta_pos`` control
steps; after each step the height of the robot's root link (the hopper's
torso: its root is a fixed anchor) per env and the summed vertical contact
force on its links per env, as a share of its weight.

    JAX_PLATFORMS=cpu python scripts/locomotion_figures.py jax --out scripts/locomotion_figures.json
    python scripts/locomotion_figures.py torch [ENV_ID ...]

The last line printed is the figures as JSON ({env id: [{"root_z": [...],
"force": [...]} per step]}); ``--out`` writes it to a file as well.

Both packages start from the same states (the port's, handed to the JAX env
through ``reset_to_env_states``); the JAX contact solver runs with its bf16
cast made an identity (``f32_solver`` in tests/test_torch_common.py). The
port's reset draws from a counter-based hash per env, so the first 16 envs
of a 4096-env reset with seed 0 start from these states too: chip_smoke.py
holds the card's figures to the JAX package's printed here.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

NUM_ENVS, STEPS = 16, 10
ENVS = ("MS-HopperStand-v1", "MS-HopperHop-v1", "MS-AntWalk-v1", "MS-AntRun-v1", "MS-HumanoidStand-v1",
        "MS-HumanoidWalk-v1", "MS-HumanoidRun-v1", "MS-HumanoidStandHard-v1", "MS-HumanoidWalkHard-v1",
        "MS-HumanoidRunHard-v1", "AnymalC-Reach-v1", "AnymalC-Spin-v1", "UnitreeGo2-Reach-v1",
        "UnitreeH1Stand-v1", "UnitreeG1Stand-v1")


def figures(base, n):
    """(root height (n,), summed vertical contact force on the robot's links
    over its weight (n,)) of the first ``n`` envs of an env's base."""
    robot = base.agent.robot
    ids = [link.body_id for link in robot.links]
    weight = float(np.asarray(base.scene.model.host_body_mass, np.float64)[ids].sum()) * 9.81
    force = np.asarray(robot.get_net_contact_forces())[:n, :, 2].sum(1) / weight
    root_link = robot.links_map["torso"] if robot.fixed_root else robot.links[0]
    root = np.asarray(root_link.pose.p)[:n, 2]
    return root, force


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("package", choices=("jax", "torch"))
    p.add_argument("envs", nargs="*", default=list(ENVS))
    p.add_argument("--out", default=None, help="also write the figures' JSON here")
    args = p.parse_args(argv)
    import torch

    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make as tmake

    torch.set_num_threads(1)
    B = NUM_ENVS
    kw = dict(num_envs=B, obs_mode="state", control_mode="pd_joint_delta_pos")
    solver = contextlib.nullcontext()
    if args.package == "jax":
        import maniskill_tpu.envs  # noqa: F401
        from maniskill_tpu.utils.registration import make as jmake
        from test_torch_common import f32_solver, tree

        solver = f32_solver()
    out = {}
    with solver:
        for uid in args.envs:
            te = tmake(uid, device="cpu", **kw)
            te.reset(seed=0)
            if args.package == "jax":
                state = tree(te.unwrapped.get_state_dict(), lambda v: v.numpy())
                env = jmake(uid, **kw)
                env.reset(seed=0, options=dict(reset_to_env_states=state))
            else:
                env = te
            base = env.unwrapped
            zero = np.zeros((B,) + base.single_action_space.shape, np.float32)
            if args.package == "torch":
                zero = torch.as_tensor(zero)
            rows = []
            for _ in range(STEPS):
                env.step(zero)
                root, force = figures(base, B)
                rows.append(dict(root_z=root.round(6).tolist(), force=force.round(6).tolist()))
            out[uid] = rows
            last = rows[-1]
            print(f"{uid}: after {STEPS} steps root z {min(last['root_z']):.4f}-{max(last['root_z']):.4f} m, "
                  f"vertical contact force / weight per step (env 0): "
                  f"{[r['force'][0] for r in rows]}", flush=True)
    text = json.dumps(out)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
