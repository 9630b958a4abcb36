"""PPO baseline CLI (counterpart of maniskill_tpu/examples/baselines/ppo.py).

Trains a state-obs policy with ``PPOTrainer`` on the card, saves it as a
flax-layout numpy pickle (loadable by either package) and evaluates it
greedily and stochastically; ``--evaluate CKPT`` only evaluates a checkpoint
(for example the JAX package's ``examples_checkpoints/ppo_pickcube_state.pkl``).

Usage:
    python -m maniskill_tpu_torch.examples.baselines.ppo --env-id PickCube-v1 \\
        --num-envs 4096 --rollout-steps 4 --update-epochs 8 --num-minibatches 32
    python -m maniskill_tpu_torch.examples.baselines.ppo --env-id PickCube-v1 \\
        --num-envs 4096 --evaluate examples_checkpoints/ppo_pickcube_state.pkl
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--env-id", default="PushCube-v1")
    p.add_argument("--num-envs", type=int, default=1024)
    p.add_argument("--rollout-steps", type=int, default=16)
    p.add_argument("--total-steps", type=int, default=2_000_000)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--gamma", type=float, default=0.8)
    p.add_argument("--gae-lambda", type=float, default=0.9)
    p.add_argument("--update-epochs", type=int, default=4)
    p.add_argument("--num-minibatches", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ignore-terminations", action="store_true")
    p.add_argument("--eval-every", type=int, default=10)
    p.add_argument("--checkpoint", default=os.path.join(tempfile.gettempdir(), "ppo_params.pkl"),
                   help="where the trained weights are saved")
    p.add_argument("--evaluate", default=None, metavar="CKPT",
                   help="evaluate this checkpoint and train nothing")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def print_metrics(it, iters, metrics, sps):
    extra = " ".join(f"{k}={float(v):.3g}" for k, v in metrics.items() if k not in ("loss", "mean_reward"))
    print(f"iter {it}/{iters} loss {float(metrics['loss']):.4f} "
          f"mean_reward {float(metrics['mean_reward']):.4f} env_steps/s {sps:,.0f} {extra}", flush=True)


def main(argv=None):
    args = parse_args(argv)

    import torch

    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make
    from maniskill_tpu_torch.parallel.train import (
        PPOConfig, PPOTrainer, evaluate, load_jax_checkpoint, params_from_flax, save_checkpoint,
    )

    env = make(args.env_id, num_envs=args.num_envs, obs_mode="state", device=args.device)
    base = env.unwrapped
    obs, _ = env.reset(seed=args.seed)

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
    trainer = PPOTrainer(env, config, obs, seed=args.seed, total_updates=iters)
    model = trainer.model

    if args.evaluate:
        model.load_state_dict(params_from_flax(load_jax_checkpoint(args.evaluate)))
    else:
        elapsed = torch.zeros(args.num_envs, dtype=torch.int32, device=base.device)
        t0 = time.time()
        for it in range(iters):
            obs, elapsed, metrics = trainer.train_step(obs, elapsed)
            if it % args.eval_every == 0 or it == iters - 1:
                print_metrics(it, iters, metrics, steps_per_iter * (it + 1) / (time.time() - t0))
        save_checkpoint(model, args.checkpoint)

    # final evaluation: greedy and stochastic, success once over one horizon
    def run(stochastic, seed):
        success = evaluate(env, model, stochastic=stochastic, seed=seed)
        # diagnostics: the final cube-goal distance distribution
        if hasattr(base, "obj"):
            dist = torch.linalg.vector_norm(base.obj.pose.p[:, :2] - base.goal_region.pose.p[:, :2], dim=1)
        else:
            dist = torch.zeros(args.num_envs)
        return float(success.float().mean()), np.percentile(dist.cpu().numpy(), [10, 50, 90])

    g_rate, g_d = run(False, 123)
    s_rate, s_d = run(True, 124)
    print(f"final eval greedy success_once: {g_rate:.3f} dist p10/50/90 {np.round(g_d, 3)}", flush=True)
    print(f"final eval stochastic success_once: {s_rate:.3f} dist p10/50/90 {np.round(s_d, 3)}", flush=True)
    return g_rate


if __name__ == "__main__":
    main()
