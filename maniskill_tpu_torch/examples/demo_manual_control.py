"""Manual-control demo CLI (counterpart of
maniskill_tpu/examples/demo_manual_control.py), from the terminal.

For end-effector-controlled arms (a ``*ee_delta_pos*`` mode) the WASD/RF
keys drive the translation; in any other control mode the number keys pick
an action dimension and +/- nudge it. Each key is one control step. Runs on
the card unless ``--device cpu`` is given.

Keys (EE mode): w/s = +-x, a/d = +-y, r/f = +-z, g = toggle gripper
Keys (generic): 0-9 select dim, +/- nudge
Common: x = reset, q = quit.

Usage:
    python -m maniskill_tpu_torch.examples.demo_manual_control -e PushCube-v1
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from .teleoperation.drag_object import _KEY_DELTAS as _EE_KEYS
from .teleoperation.drag_object import _read_key  # noqa: F401 (the seam tests patch)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-e", "--env-id", default="PushCube-v1")
    p.add_argument("-c", "--control-mode", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save-frames", default=None)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Runs until ``q``; returns each step's action, reward and success, and
    the env."""
    args = parse_args(argv)
    from .. import envs  # noqa: F401 (registers the tasks)
    from ..utils.registration import make
    from ..utils.visualization import save_image

    env = make(args.env_id, num_envs=1, control_mode=args.control_mode,
               render_mode="rgb_array" if args.save_frames else None, device=args.device)
    base = env.unwrapped
    act_dim = int(np.prod(base.single_action_space.shape))
    mode = base.control_mode or ""
    ee = "ee_delta_pos" in mode
    env.reset(seed=args.seed)
    print(f"control mode {mode}, action dim {act_dim}; q to quit")
    gripper, dim = 1.0, 0
    actions, rewards, successes = [], [], []
    while True:
        ch = _read_key()
        if ch in ("q", "\x03"):
            break
        if ch == "x":
            env.reset()
            continue
        action = np.zeros(act_dim, np.float32)
        if ee:
            if ch == "g":
                gripper = -gripper
            elif ch in _EE_KEYS:
                action[:3] = _EE_KEYS[ch]
            action[-1] = gripper
        else:
            if ch.isdigit():
                dim = min(int(ch), act_dim - 1)
                print(f"selected dim {dim}")
                continue
            if ch in ("+", "="):
                action[dim] = 1.0
            elif ch == "-":
                action[dim] = -1.0
        _, rew, _, _, info = env.step(action[None])
        actions.append(action)
        rewards.append(float(rew[0]))
        successes.append(bool(info["success"].any()) if "success" in info else False)
        t = len(actions)
        print(f"t={t} reward {rewards[-1]:.3f} success {successes[-1]}")
        if args.save_frames:
            os.makedirs(args.save_frames, exist_ok=True)
            save_image(f"{args.save_frames}/{t:04d}.png", env.render()[0])
    env.close()
    return dict(action=np.asarray(actions), reward=np.asarray(rewards), success=np.asarray(successes), env=env)


if __name__ == "__main__":
    main()
