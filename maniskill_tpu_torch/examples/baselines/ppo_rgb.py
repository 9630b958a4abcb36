"""Visual PPO baseline CLI (counterpart of
maniskill_tpu/examples/baselines/ppo_rgb.py).

The same flow as the state PPO CLI with a visual obs mode: the camera
renders through the CUDA rasterizer inside the rollout and the NatureCNN
policy (bfloat16 convolutions) consumes the frames on the card; with
``--obs-mode rgbd`` (or ``rgb+depth``) a second tower reads the camera's
int16 depth.
``--evaluate CKPT`` only evaluates a checkpoint (for example the JAX
package's ``examples_checkpoints/ppo_pushcube_rgb.pkl``).

Usage:
    python -m maniskill_tpu_torch.examples.baselines.ppo_rgb --env-id PushCube-v1 \\
        --num-envs 512 --rollout-steps 8 --total-steps 12000000
    python -m maniskill_tpu_torch.examples.baselines.ppo_rgb --env-id PushCube-v1 --obs-mode rgbd \\
        --num-envs 512 --rollout-steps 8 --total-steps 12000000
    python -m maniskill_tpu_torch.examples.baselines.ppo_rgb --env-id PushCube-v1 \\
        --num-envs 512 --evaluate examples_checkpoints/ppo_pushcube_rgb.pkl
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--env-id", default="PickCube-v1")
    p.add_argument("--obs-mode", default="rgb", help="rgb | rgbd | rgb+depth")
    p.add_argument("--num-envs", type=int, default=256)
    p.add_argument("--rollout-steps", type=int, default=8)
    p.add_argument("--total-steps", type=int, default=10_000_000)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--gamma", type=float, default=0.8)
    p.add_argument("--gae-lambda", type=float, default=0.9)
    p.add_argument("--update-epochs", type=int, default=4)
    p.add_argument("--num-minibatches", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ignore-terminations", action="store_true")
    p.add_argument("--eval-every", type=int, default=10)
    p.add_argument("--checkpoint", default=os.path.join(tempfile.gettempdir(), "ppo_rgb_params.pkl"))
    p.add_argument("--save-every", type=int, default=200, help="iters between checkpoint saves")
    p.add_argument("--evaluate", default=None, metavar="CKPT",
                   help="evaluate this checkpoint and train nothing")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch

    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make
    from maniskill_tpu_torch.examples.baselines.ppo import print_metrics
    from maniskill_tpu_torch.parallel.train import (
        PPOConfig, PPOTrainer, evaluate, load_jax_checkpoint, params_from_flax, save_checkpoint,
    )

    env = make(args.env_id, num_envs=args.num_envs, obs_mode=args.obs_mode, device=args.device)
    base = env.unwrapped
    raw_obs, _ = env.reset(seed=args.seed)

    config = PPOConfig(
        rollout_steps=args.rollout_steps,
        gamma=args.gamma,
        gae_lambda=args.gae_lambda,
        lr=args.lr,
        update_epochs=args.update_epochs,
        num_minibatches=args.num_minibatches,
        ignore_terminations=args.ignore_terminations,
    )
    steps_per_iter = args.num_envs * args.rollout_steps
    iters = max(1, args.total_steps // steps_per_iter)
    trainer = PPOTrainer(env, config, raw_obs, seed=args.seed, total_updates=iters)
    model = trainer.model
    obs = trainer.obs_tf(raw_obs)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"obs: { {k: (tuple(v.shape), str(v.dtype)) for k, v in obs.items()} } params: {n_params:,}",
          flush=True)

    if args.evaluate:
        model.load_state_dict(params_from_flax(load_jax_checkpoint(args.evaluate)))
    else:
        elapsed = torch.zeros(args.num_envs, dtype=torch.int32, device=base.device)
        t0 = time.time()
        for it in range(iters):
            obs, elapsed, metrics = trainer.train_step(obs, elapsed)
            if it % args.eval_every == 0 or it == iters - 1:
                print_metrics(it, iters, metrics, steps_per_iter * (it + 1) / (time.time() - t0))
            if args.save_every and it and it % args.save_every == 0:
                save_checkpoint(model, args.checkpoint)
        save_checkpoint(model, args.checkpoint)

    # final evaluation (greedy), success once over one horizon
    rate = float(evaluate(env, model, stochastic=False, seed=123).float().mean())
    print(f"final eval greedy success_once: {rate:.3f}", flush=True)
    return rate


if __name__ == "__main__":
    main()
