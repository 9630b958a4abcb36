"""Reset-distribution demo CLI (counterpart of
maniskill_tpu/examples/demo_reset_distribution.py): resets an env repeatedly
with different seeds and saves one rendered frame per reset (``--shader``
picks the human camera's shader pack, ``rt-fast`` etc. path-traced), so the
initial state randomization can be inspected. Runs on the card unless
``--device cpu`` is given.

Usage:
    python -m maniskill_tpu_torch.examples.demo_reset_distribution -e PushCube-v1 \
        -n 20 --record-dir out/resets
"""
from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-e", "--env-id", default="PushCube-v1")
    p.add_argument("-n", "--num-resets", type=int, default=20)
    p.add_argument("--shader", default="minimal")
    p.add_argument("--record-dir", default="videos/reset_distributions")
    p.add_argument("-s", "--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Returns the frames (one (H, W, 3) uint8 tensor per reset), the
    video's path and the env."""
    args = parse_args(argv)
    from .. import envs  # noqa: F401 (registers the tasks)
    from ..utils.registration import make
    from ..utils.visualization import images_to_video

    env = make(args.env_id, num_envs=1, obs_mode="state", reward_mode="none", render_mode="rgb_array",
               human_render_camera_configs=dict(shader_pack=args.shader), device=args.device)
    frames = []
    for i in range(args.num_resets):
        env.reset(seed=args.seed + i)
        frames.append(env.render()[0])
    env.close()
    path = images_to_video(frames, args.record_dir, video_name=f"{args.env_id}_reset_distribution", fps=2)
    print(f"saved {len(frames)} reset frames to {path}")
    return dict(frames=frames, path=path, env=env)


if __name__ == "__main__":
    main()
