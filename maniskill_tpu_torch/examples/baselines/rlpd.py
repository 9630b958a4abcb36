"""RLPD baseline (counterpart of maniskill_tpu/examples/baselines/rlpd.py,
after Ball et al. 2023, "Efficient Online RL with Offline Data").

SAC (maniskill_tpu_torch/parallel/sac.py) with every update batch half
online replay and half demo transitions, loaded from a RecordEpisode .h5
(recorded with rewards) onto the env's device. Runs on the card unless
``--device cpu`` is given.

As in the JAX package, the env runs in its default control mode whatever
mode the demos were recorded in, and the last transition of every demo
episode counts as terminal, truncated or not. The CLI prints the demo
JSON's control mode beside the env's, so a mismatch shows: the planner's
demos are ``pd_joint_pos``, and absolute and delta actions of the same
width mix silently.

Usage:
    python -m maniskill_tpu_torch.examples.baselines.rlpd --env-id PickCube-v1 \\
        --traj-path demos.h5 --num-envs 256 --total-steps 2000000
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import tempfile
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--env-id", default="PushCube-v1")
    p.add_argument("--traj-path", required=True)
    p.add_argument("--num-envs", type=int, default=256)
    p.add_argument("--rollout-steps", type=int, default=4)
    p.add_argument("--buffer-steps", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--utd", type=int, default=4)
    p.add_argument("--gamma", type=float, default=0.9)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--total-steps", type=int, default=1_000_000)
    p.add_argument("--warmup-steps", type=int, default=20)
    p.add_argument("--eval-every", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ignore-terminations", action="store_true")
    p.add_argument("--save-path", default=os.path.join(tempfile.gettempdir(), "rlpd_params.pkl"))
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def load_demo_transitions(traj_path: str):
    """(obs, act, rew, next_obs, term) flat transition arrays from h5; the
    last transition of every episode is terminal."""
    from maniskill_tpu_torch.examples.baselines.bc import _flatten_obs
    from maniskill_tpu_torch.trajectory.dataset import ManiSkillTrajectoryDataset

    ds = ManiSkillTrajectoryDataset(traj_path)
    O, A, R, NO, T = [], [], [], [], []
    for ep in range(len(ds.actions)):
        acts = np.asarray(ds.actions[ep], np.float32)
        batched = acts.ndim == 3
        obs = _flatten_obs(ds.obs[ep], 2 if batched else 1)
        rew = (np.asarray(ds.rewards[ep], np.float32) if ds.rewards
               else np.zeros(acts.shape[:-1], np.float32))
        n = len(acts)
        term = np.zeros(acts.shape[:-1], bool)
        term[-1] = True
        o, no = obs[:n], obs[1:n + 1]
        if batched:
            o, no = o.reshape(-1, o.shape[-1]), no.reshape(-1, no.shape[-1])
            a, r, t = acts.reshape(-1, acts.shape[-1]), rew.reshape(-1), term.reshape(-1)
        else:
            a, r, t = acts, rew, term
        O.append(o), A.append(a), R.append(r), NO.append(no), T.append(t)
    ds.close()
    return dict(obs=np.concatenate(O), act=np.concatenate(A), rew=np.concatenate(R),
                next_obs=np.concatenate(NO), term=np.concatenate(T))


def main(argv=None):
    """Returns dict(trainer, obs, elapsed, env_steps_per_s, eval_success,
    metrics) for a caller that goes on with the trainer."""
    args = parse_args(argv)

    import torch

    import maniskill_tpu_torch.envs  # noqa: F401
    from maniskill_tpu_torch import make
    from maniskill_tpu_torch.parallel.sac import SACConfig, SACTrainer, actor_params_to_flax, evaluate

    demos_np = load_demo_transitions(args.traj_path)
    print(f"demo buffer: {demos_np['obs'].shape[0]} transitions")

    env = make(args.env_id, num_envs=args.num_envs, obs_mode="state", device=args.device)
    base = env.unwrapped
    meta_path = args.traj_path.replace(".h5", ".json")
    demo_mode = None
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            demo_mode = json.load(f)["env_info"]["env_kwargs"].get("control_mode")
    print(f"control mode: demos {demo_mode}, env {base.control_mode}"
          + ("" if demo_mode in (None, base.control_mode) else " (they differ: the demo actions are used as they are)"))
    demos = {k: torch.as_tensor(v, device=base.device) for k, v in demos_np.items()}
    obs, _ = env.reset(seed=args.seed)
    obs_dim = obs.shape[-1]
    assert demos_np["obs"].shape[-1] == obs_dim, (
        f"demo obs dim {demos_np['obs'].shape[-1]} != env obs dim {obs_dim}")

    config = SACConfig(
        rollout_steps=args.rollout_steps,
        buffer_steps=args.buffer_steps,
        batch_size=args.batch_size,
        utd=args.utd,
        gamma=args.gamma,
        lr=args.lr,
        ignore_terminations=args.ignore_terminations,
    )
    trainer = SACTrainer(env, config, obs_dim, seed=args.seed, demos=demos)
    elapsed = torch.zeros(args.num_envs, dtype=torch.int32, device=base.device)

    steps_per_iter = args.num_envs * args.rollout_steps
    iters = args.total_steps // steps_per_iter
    t0 = time.time()
    metrics = {}
    for it in range(iters):
        obs, elapsed, metrics = trainer.train_step(obs, elapsed, learn=it >= args.warmup_steps)
        if it % args.eval_every == 0 or it == iters - 1:
            m = {k: float(v) for k, v in metrics.items()}
            sps = steps_per_iter * (it + 1) / (time.time() - t0)
            print(f"iter {it}/{iters} q_loss {m['q_loss']:.4f} actor_loss {m['actor_loss']:.4f} "
                  f"env_steps/s {sps:,.0f}", flush=True)
    sps = steps_per_iter * iters / max(time.time() - t0, 1e-9)

    with open(args.save_path, "wb") as f:
        pickle.dump(actor_params_to_flax(trainer.actor.state_dict()), f)

    success, _ = evaluate(env, trainer.actor, seed=args.seed + 1000)
    rate = float(success.float().mean())
    print(f"final eval success(any): {rate:.3f}")
    return dict(trainer=trainer, obs=obs, elapsed=elapsed, env_steps_per_s=sps, eval_success=rate,
                metrics={k: float(v) for k, v in metrics.items()})


if __name__ == "__main__":
    main()
