"""Robot showcase CLI (counterpart of maniskill_tpu/examples/demo_robot.py).

Loads a registered robot into Empty-v1, prints its structure (links,
joints, controllers, keyframes), optionally cycles through its keyframes and
saves rendered frames. Runs on the card unless ``--device cpu`` is given.

Usage:
    python -m maniskill_tpu_torch.examples.demo_robot -r panda [--keyframes]
    python -m maniskill_tpu_torch.examples.demo_robot --list
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-r", "--robot-uid", default="panda")
    p.add_argument("--list", action="store_true", help="list registered robots")
    p.add_argument("--keyframes", action="store_true", help="cycle keyframes")
    p.add_argument("--steps", type=int, default=20, help="settle steps per keyframe")
    p.add_argument("--save-frames", default=None)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Returns the robot's structure, each keyframe's qpos after settling and
    the env (with ``--list``, the registered uids)."""
    args = parse_args(argv)

    import torch

    from .. import envs  # noqa: F401 (registers the tasks)
    from ..agents.registration import REGISTERED_AGENTS
    from ..utils.registration import make
    from ..utils.visualization import save_image

    if args.list:
        for uid in sorted(REGISTERED_AGENTS):
            print(uid)
        return dict(uids=sorted(REGISTERED_AGENTS))

    env = make("Empty-v1", num_envs=1, obs_mode="state", robot_uids=args.robot_uid,
               render_mode="rgb_array" if args.save_frames else None, device=args.device)
    base = env.unwrapped
    env.reset(seed=0)
    agent = base.agent
    robot = agent.robot
    info = dict(dof=robot.dof, links=[l.name for l in robot.links], active_joints=[j.name for j in robot.active_joints],
                control_modes=list(agent._controller_configs.keys()),
                keyframes=list(getattr(agent, "keyframes", {}).keys()))
    print(f"robot: {args.robot_uid}")
    print(f"  dof: {info['dof']}")
    print(f"  links ({len(info['links'])}): {info['links']}")
    print(f"  active joints: {info['active_joints']}")
    print(f"  control modes: {info['control_modes']}")
    print(f"  action space: {base.single_action_space}")
    print(f"  keyframes: {info['keyframes']}")

    settled = {}
    if args.keyframes:
        if args.save_frames:
            os.makedirs(args.save_frames, exist_ok=True)
        act = torch.zeros((1,) + base.single_action_space.shape, device=base.device)
        for name, kf in getattr(agent, "keyframes", {}).items():
            if kf.qpos is not None:
                agent.reset(torch.as_tensor(np.asarray(kf.qpos, np.float32), device=base.device))
            for _ in range(args.steps):
                env.step(act)
            q = robot.qpos[0].cpu().numpy()
            settled[name] = q
            print(f"keyframe {name}: qpos after settle {np.round(q, 3)}")
            if args.save_frames:
                save_image(f"{args.save_frames}/{name}.png", env.render()[0])
    env.close()
    return dict(info, settled=settled, env=env)


if __name__ == "__main__":
    main()
