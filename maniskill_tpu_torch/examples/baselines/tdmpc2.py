"""TD-MPC2 baseline CLI (counterpart of
maniskill_tpu/examples/baselines/tdmpc2.py).

Model-based RL on the card (maniskill_tpu_torch/parallel/tdmpc2.py): each
iteration plans ``--rollout-steps`` control steps with the MPPI planner (or,
with ``--no-mpc``, samples the policy prior) and, once the ring holds a
whole episode, makes ``--num-updates`` updates. The world model and the
policy are saved as the JAX package's pickled flax trees
(``dict(model=..., pi=...)``), then the planner acts greedily for one
episode.

Usage:
    python -m maniskill_tpu_torch.examples.baselines.tdmpc2 --env-id PushCube-v1 \\
        --num-envs 32 --total-steps 200000
    python -m maniskill_tpu_torch.examples.baselines.tdmpc2 --env-id PushCube-v1 --device cpu \\
        --num-envs 2 --no-mpc --total-steps 104 --warmup-steps 0
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
    p.add_argument("--num-envs", type=int, default=32)
    p.add_argument("--rollout-steps", type=int, default=4)
    p.add_argument("--buffer-steps", type=int, default=1000)
    p.add_argument("--total-steps", type=int, default=200_000)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--num-updates", type=int, default=2)
    p.add_argument("--horizon", type=int, default=3)
    p.add_argument("--num-samples", type=int, default=512)
    p.add_argument("--no-mpc", action="store_true", help="act with the policy prior instead of MPPI")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--warmup-steps", type=int, default=20)
    p.add_argument("--eval-every", type=int, default=50)
    p.add_argument("--save-path", default=os.path.join(tempfile.gettempdir(), "tdmpc2_params.pkl"))
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch

    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make
    from maniskill_tpu_torch.parallel.tdmpc2 import (
        TDMPC2Config, TDMPC2Trainer, model_params_to_flax, pi_params_to_flax,
    )
    from maniskill_tpu_torch.utils.gym_utils import find_max_episode_steps_value

    env = make(args.env_id, num_envs=args.num_envs, obs_mode="state", device=args.device)
    base = env.unwrapped
    obs, _ = env.reset(seed=args.seed)

    ep_len = find_max_episode_steps_value(env) or 50
    buffer_steps = (max(args.buffer_steps, ep_len) // ep_len) * ep_len
    config = TDMPC2Config(
        mpc=not args.no_mpc,
        horizon=args.horizon,
        num_samples=args.num_samples,
        rollout_steps=args.rollout_steps,
        buffer_steps=buffer_steps,
        batch_size=args.batch_size,
        num_updates=args.num_updates,
    )
    trainer = TDMPC2Trainer(env, config, obs.shape[-1], seed=args.seed)
    elapsed = torch.zeros(args.num_envs, dtype=torch.int32, device=base.device)

    steps_per_iter = args.num_envs * args.rollout_steps
    iters = args.total_steps // steps_per_iter
    # learning starts once at least one full episode per ring row exists
    warmup = max(args.warmup_steps, ep_len // args.rollout_steps)
    t0 = time.time()
    for it in range(iters):
        obs, elapsed, metrics = trainer.train_step(obs, elapsed, learn=it >= warmup)
        if it % args.eval_every == 0 or it == iters - 1:
            m = {k: float(v) for k, v in metrics.items()}
            sps = steps_per_iter * (it + 1) / (time.time() - t0)
            print(f"iter {it}/{iters} consistency {m['consistency_loss']:.4f} reward {m['reward_loss']:.4f} "
                  f"value {m['value_loss']:.4f} pi {m['pi_loss']:.4f} q_scale {m['q_scale']:.2f} "
                  f"env_steps/s {sps:,.0f}", flush=True)

    with open(args.save_path, "wb") as f:
        pickle.dump(dict(model=model_params_to_flax(trainer.model.state_dict()),
                         pi=pi_params_to_flax(trainer.pi.state_dict())), f)
    print(f"saved world model + policy to {args.save_path}")

    # greedy eval with the planner over one episode
    obs, _ = env.reset(seed=args.seed + 1000)
    success = torch.zeros(args.num_envs, dtype=torch.bool, device=base.device)
    rew_sum = torch.zeros((), device=base.device)
    elapsed_ev = torch.zeros(args.num_envs, dtype=torch.int32, device=base.device)
    for _ in range(ep_len):
        a = trainer.act(obs, elapsed_ev == 0, eval_mode=True)
        obs, rew, term, _, info = env.step(a)
        elapsed_ev = elapsed_ev + 1
        success |= info.get("success", term)
        rew_sum += rew.mean()
    rate = float(success.float().mean())
    print(f"final eval success(any): {rate:.3f} mean_reward: {float(rew_sum) / ep_len:.3f}")
    return rate


if __name__ == "__main__":
    main()
