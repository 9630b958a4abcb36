"""Pointcloud visualization CLI (counterpart of
maniskill_tpu/examples/demo_vis_pcd.py): steps an env in pointcloud obs mode
and writes the merged world-frame cloud to .ply (ASCII) or .npy for external
viewers. Runs on the card unless ``--device cpu`` is given.

Usage:
    python -m maniskill_tpu_torch.examples.demo_vis_pcd -e PushCube-v1 -o pcd.ply
"""
from __future__ import annotations

import argparse

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-e", "--env-id", default="PushCube-v1")
    p.add_argument("-o", "--output", default="pcd.ply")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def write_ply(path, xyz, rgb):
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(xyz)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        for p, c in zip(xyz, rgb):
            f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f} {c[0]} {c[1]} {c[2]}\n")


def main(argv=None):
    """Returns env 0's foreground points (xyz, rgb) and the env."""
    args = parse_args(argv)

    import torch

    from .. import envs  # noqa: F401 (registers the tasks)
    from ..utils.registration import make

    env = make(args.env_id, num_envs=1, obs_mode="pointcloud", device=args.device)
    base = env.unwrapped
    obs, _ = env.reset(seed=args.seed)
    act = torch.zeros((1,) + base.single_action_space.shape, device=base.device)
    for _ in range(args.steps):
        obs, *_ = env.step(act)
    pcd = obs["pointcloud"]
    xyzw = pcd["xyzw"][0].cpu().numpy()
    rgb = pcd["rgb"][0].cpu().numpy()
    valid = xyzw[:, 3] > 0
    xyz, rgb = xyzw[valid, :3], rgb[valid]
    print(f"{valid.sum()} foreground points")
    if args.output.endswith(".ply"):
        write_ply(args.output, xyz, rgb)
    else:
        np.save(args.output, np.concatenate([xyz, rgb], axis=-1))
    print(f"wrote {args.output}")
    env.close()
    return dict(xyz=xyz, rgb=rgb, env=env)


if __name__ == "__main__":
    main()
