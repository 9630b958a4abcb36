"""SAC baseline CLI (counterpart of maniskill_tpu/examples/baselines/sac.py).

Off-policy training with the replay ring on the card
(maniskill_tpu_torch/parallel/sac.py): each iteration collects
``--rollout-steps`` control steps and, after ``--warmup-steps`` iterations,
makes ``--utd`` updates. The actor is saved as the JAX package's pickled
flax tree, then run greedily (``tanh(mean)``) for 60 steps (``evaluate``).

Usage:
    python -m maniskill_tpu_torch.examples.baselines.sac --env-id PushCube-v1 \\
        --num-envs 128 --total-steps 1000000
    python -m maniskill_tpu_torch.examples.baselines.sac --env-id PushCube-v1 --device cpu \\
        --num-envs 4 --total-steps 64 --batch-size 32 --buffer-steps 16 --warmup-steps 2
"""
from __future__ import annotations

import argparse
import os
import pickle
import tempfile
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--env-id", default="PushCube-v1")
    p.add_argument("--num-envs", type=int, default=128)
    p.add_argument("--rollout-steps", type=int, default=4)
    p.add_argument("--buffer-steps", type=int, default=512)
    p.add_argument("--total-steps", type=int, default=1_000_000)
    p.add_argument("--batch-size", type=int, default=4096)
    p.add_argument("--utd", type=int, default=4)
    p.add_argument("--gamma", type=float, default=0.9)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup-steps", type=int, default=40)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval-every", type=int, default=200)
    p.add_argument("--ignore-terminations", action="store_true")
    p.add_argument("--save-path", default=os.path.join(tempfile.gettempdir(), "sac_params.pkl"))
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch

    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make
    from maniskill_tpu_torch.parallel.sac import SACConfig, SACTrainer, actor_params_to_flax, evaluate

    env = make(args.env_id, num_envs=args.num_envs, obs_mode="state", device=args.device)
    base = env.unwrapped
    obs, _ = env.reset(seed=args.seed)

    config = SACConfig(
        rollout_steps=args.rollout_steps,
        buffer_steps=args.buffer_steps,
        batch_size=args.batch_size,
        utd=args.utd,
        gamma=args.gamma,
        lr=args.lr,
        ignore_terminations=args.ignore_terminations,
    )
    trainer = SACTrainer(env, config, obs.shape[-1], seed=args.seed)
    elapsed = torch.zeros(args.num_envs, dtype=torch.int32, device=base.device)

    steps_per_iter = args.num_envs * args.rollout_steps
    iters = args.total_steps // steps_per_iter
    t0 = time.time()
    for it in range(iters):
        obs, elapsed, metrics = trainer.train_step(obs, elapsed, learn=it >= args.warmup_steps)
        if it % args.eval_every == 0 or it == iters - 1:
            m = {k: float(v) for k, v in metrics.items()}
            sps = steps_per_iter * (it + 1) / (time.time() - t0)
            print(f"iter {it}/{iters} q_loss {m['q_loss']:.4f} actor_loss {m['actor_loss']:.4f} "
                  f"alpha {m['alpha']:.3f} env_steps/s {sps:,.0f}", flush=True)

    with open(args.save_path, "wb") as f:
        pickle.dump(actor_params_to_flax(trainer.actor.state_dict()), f)
    print(f"saved actor params to {args.save_path}")

    success, mean_reward = evaluate(env, trainer.actor, seed=args.seed + 1000)
    rate = float(success.float().mean())
    print(f"final eval success(any): {rate:.3f} mean_reward: {float(mean_reward):.3f}")
    return rate


if __name__ == "__main__":
    main()
