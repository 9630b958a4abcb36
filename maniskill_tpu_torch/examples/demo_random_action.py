"""Random-action demo CLI (counterpart of
maniskill_tpu/examples/demo_random_action.py). Runs on the card unless
``--device cpu`` is given.

Usage:
    python -m maniskill_tpu_torch.examples.demo_random_action -e PushCube-v1 -n 4 \
        [--render-mode rgb_array --record-dir out/]
"""
from __future__ import annotations

import argparse

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-e", "--env-id", default="PushCube-v1")
    p.add_argument("-n", "--num-envs", type=int, default=4)
    p.add_argument("-o", "--obs-mode", default="state")
    p.add_argument("-c", "--control-mode", default=None)
    p.add_argument("--render-mode", default=None)
    p.add_argument("--record-dir", default=None)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Returns each step's mean reward and success count, and the env."""
    args = parse_args(argv)
    from .. import envs  # noqa: F401 (registers the tasks)
    from ..utils.registration import make

    env = make(args.env_id, num_envs=args.num_envs, obs_mode=args.obs_mode, control_mode=args.control_mode,
               render_mode=args.render_mode, device=args.device)
    if args.record_dir:
        from ..wrappers.record import RecordEpisode

        env = RecordEpisode(env, args.record_dir, save_video=args.render_mode is not None)
    base = env.unwrapped
    base.print_sim_details()
    rng = np.random.default_rng(args.seed)
    env.reset(seed=args.seed)
    rewards, successes = [], []
    for i in range(args.steps):
        _, reward, _, _, info = env.step(base.action_space.sample(rng))
        rewards.append(float(reward.float().mean()))
        successes.append(int(info["success"].sum()) if "success" in info else 0)
        if i % 10 == 0:
            print(f"step {i}: reward mean {rewards[-1]:.3f} success {successes[-1]}")
    env.close()
    return dict(reward=np.asarray(rewards), success=np.asarray(successes), env=env)


if __name__ == "__main__":
    main()
