"""Object-drag teleoperation through a 6-dof drive (counterpart of
maniskill_tpu/examples/teleoperation/drag_object.py).

A world-anchored spring-damper drive (structs/drive.py) holds a chosen
actor; keys move the drive's target and the object follows physically,
contacts and all, instead of teleporting. The terminal front end only: each
key is one control step, and each step prints the target and the object's
position. Runs on the card unless ``--device cpu`` is given.

Keys: w/s = +-x, a/d = +-y, r/f = +-z, x = reset, q = quit.

Usage:
    python -m maniskill_tpu_torch.examples.teleoperation.drag_object \\
        --env-id PushCube-v1 --actor cube [--save-frames frames/]
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

_KEY_DELTAS = {
    "w": (1, 0, 0), "s": (-1, 0, 0),
    "a": (0, 1, 0), "d": (0, -1, 0),
    "r": (0, 0, 1), "f": (0, 0, -1),
}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--env-id", default="PushCube-v1")
    p.add_argument("--actor", default="cube")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--speed", type=float, default=0.02, help="target step (m)")
    p.add_argument("--save-frames", default=None)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _read_key() -> str:
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setraw(fd)
        return sys.stdin.read(1)
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


def save_frame(directory: str, t: int, frame: np.ndarray):
    """A PNG where Pillow is installed, else the array as .npy."""
    from ...utils.visualization import save_image

    save_image(f"{directory}/{t:05d}.png", frame)


class _DragEnvFactory:
    """Builds the env with a world-anchored drive on the chosen actor by
    hooking ``_load_scene`` (a drive must exist before the model is
    finalized)."""

    def __init__(self, env_id, actor_name, stiffness=(300.0, 5.0), damping=(30.0, 0.5), force_limit=(30.0, 2.0)):
        from ... import envs  # noqa: F401 (registers the tasks)
        from ...utils.registration import REGISTERED_ENVS

        spec = REGISTERED_ENVS[env_id]
        self.default_kwargs = dict(spec.default_kwargs or {})
        factory = self

        class DragEnv(spec.cls):
            def _load_scene(self, options):
                super()._load_scene(options)
                target = self.scene.actors[actor_name]
                factory.drive = self.scene.create_drive(
                    None, None, target, None, stiffness=stiffness, damping=damping, force_limit=force_limit,
                )

        self.cls = DragEnv

    def make(self, **kwargs):
        return self.cls(**{**self.default_kwargs, **kwargs})


def _target_pose(p: np.ndarray) -> np.ndarray:
    return np.concatenate([p, [1, 0, 0, 0]]).astype(np.float32)


def main(argv=None):
    """Runs the loop until ``q``; returns each step's target and object
    position (host arrays)."""
    args = parse_args(argv)
    import torch

    factory = _DragEnvFactory(args.env_id, args.actor)
    env = factory.make(num_envs=1, obs_mode="state", render_mode="rgb_array" if args.save_frames else None,
                       device=args.device)
    env.reset(seed=args.seed)
    drive = factory.drive
    actor = env.scene.actors[args.actor]
    target = actor.pose.p[0].cpu().numpy().copy()
    drive.set_drive_target(_target_pose(target))
    if args.save_frames:
        os.makedirs(args.save_frames, exist_ok=True)

    act = torch.zeros((1,) + tuple(env.single_action_space.shape), device=env.device)
    targets, positions = [], []
    print(__doc__.split("Keys:")[1].split("Usage:")[0])
    while True:
        key = _read_key()
        if key in ("q", "\x03"):
            break
        if key == "x":
            env.reset(seed=args.seed)
            target = actor.pose.p[0].cpu().numpy().copy()
        target = target + np.array(_KEY_DELTAS.get(key, (0, 0, 0)), np.float32) * args.speed
        drive.set_drive_target(_target_pose(target))
        env.step(act)
        p = actor.pose.p[0].cpu().numpy()
        targets.append(target.copy())
        positions.append(p)
        t = len(targets)
        print(f"step {t} target=[{target[0]:+.3f} {target[1]:+.3f} {target[2]:+.3f}] "
              f"obj=[{p[0]:+.3f} {p[1]:+.3f} {p[2]:+.3f}]", flush=True)
        if args.save_frames:
            save_frame(args.save_frames, t, env.render()[0].cpu().numpy())
    env.close()
    return dict(targets=np.asarray(targets), positions=np.asarray(positions), env=env)


if __name__ == "__main__":
    main()
