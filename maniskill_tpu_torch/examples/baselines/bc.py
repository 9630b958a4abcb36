"""Behavior-cloning baseline CLI (counterpart of
maniskill_tpu/examples/baselines/bc.py).

Trains an MLP policy (three ReLU layers of ``--hidden``, then a linear
head; plain ``nn.Linear``, as the reference's flax ``Dense``) on the
(obs, action) pairs of a RecordEpisode .h5 file with Adam (optax's
defaults) on the MSE, one shuffled pass of ``--batch-size`` minibatches per
epoch, then evaluates it in the env the demo JSON names, with its
``env_kwargs``. The params are saved as a torch state dict. Runs on the
card unless ``--device cpu`` is given.

Usage:
    python -m maniskill_tpu_torch.examples.baselines.bc \\
        --traj-path out/mp_PickCube-v1.h5 --epochs 50 [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch
from torch import nn


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--traj-path", required=True)
    p.add_argument("--env-id", default=None, help="eval env; default from traj meta")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num-eval-envs", type=int, default=16)
    p.add_argument("--eval-steps", type=int, default=60)
    p.add_argument("--save-path", default=os.path.join(tempfile.gettempdir(), "bc_params.pt"))
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def _flatten_obs(o, lead_dims: int) -> np.ndarray:
    """Flatten a (possibly nested dict) obs record, keeping ``lead_dims``
    leading axes; dict entries in sorted key order."""
    if isinstance(o, dict):
        return np.concatenate([_flatten_obs(o[k], lead_dims) for k in sorted(o.keys())], axis=-1)
    a = np.asarray(o, np.float32)
    return a.reshape(a.shape[:lead_dims] + (-1,))


def load_dataset(traj_path: str):
    """(X, Y, meta): every episode's obs_t and action_t stacked."""
    from maniskill_tpu_torch.trajectory.dataset import ManiSkillTrajectoryDataset

    ds = ManiSkillTrajectoryDataset(traj_path)
    X, Y = [], []
    for ep in range(len(ds.actions)):
        acts = np.asarray(ds.actions[ep], np.float32)
        batched = acts.ndim == 3  # (T, B, A): a vectorized layout
        obs = _flatten_obs(ds.obs[ep], 2 if batched else 1)
        o, a = obs[:len(acts)], acts
        if batched:
            o, a = o.reshape(-1, o.shape[-1]), a.reshape(-1, a.shape[-1])
        X.append(o)
        Y.append(a)
    ds.close()
    return np.concatenate(X, 0), np.concatenate(Y, 0), ds.meta


class Policy(nn.Module):
    def __init__(self, obs_dim: int, act_dim: int, hidden: int = 256, seed: int = 0):
        super().__init__()
        from maniskill_tpu_torch.parallel.train import _flax_dense_init

        self.net = nn.Sequential(nn.Linear(obs_dim, hidden), nn.ReLU(), nn.Linear(hidden, hidden), nn.ReLU(),
                                 nn.Linear(hidden, hidden), nn.ReLU(), nn.Linear(hidden, act_dim))
        g = torch.Generator().manual_seed(seed)
        for layer in self.net[::2]:
            _flax_dense_init(layer, g)

    def forward(self, x):
        return self.net(x)


# the flax module's auto-named layers (parallel/train.py:params_from_flax)
FLAX_NAMES = {"Dense_0": "net.0", "Dense_1": "net.2", "Dense_2": "net.4", "Dense_3": "net.6"}


def epoch_step(policy: nn.Module, opt, X: torch.Tensor, Y: torch.Tensor, batch_size: int,
               perm: torch.Tensor) -> torch.Tensor:
    """One pass over ``n // batch_size`` minibatches of ``perm``; the mean
    minibatch MSE as a device scalar."""
    n = X.shape[0]
    bs = min(batch_size, n)
    losses = []
    for i in range(max(1, n // bs)):
        idx = perm[i * bs:(i + 1) * bs]
        loss = torch.mean((policy(X[idx]) - Y[idx]) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return torch.stack(losses).mean()


def main(argv=None):
    """Returns dict(mse=[per epoch], epochs_per_s, eval_success)."""
    args = parse_args(argv)
    dev = torch.device(args.device)
    X_np, Y_np, meta = load_dataset(args.traj_path)
    print(f"dataset: {X_np.shape[0]} transitions, obs {X_np.shape[1]}, act {Y_np.shape[1]}")

    policy = Policy(X_np.shape[1], Y_np.shape[1], args.hidden, seed=args.seed).to(dev)
    opt = torch.optim.Adam(policy.parameters(), lr=args.lr, eps=1e-8)
    X, Y = torch.as_tensor(X_np, device=dev), torch.as_tensor(Y_np, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)

    mse = []
    t0 = time.time()
    for e in range(args.epochs):
        mse.append(epoch_step(policy, opt, X, Y, args.batch_size, torch.randperm(X.shape[0], generator=g, device=dev)))
        if e % max(1, args.epochs // 10) == 0 or e == args.epochs - 1:
            print(f"epoch {e}/{args.epochs} mse {float(mse[-1]):.5f} ({time.time() - t0:.1f}s)", flush=True)
    mse = [float(m) for m in mse]
    epochs_per_s = args.epochs / (time.time() - t0)

    torch.save(policy.state_dict(), args.save_path)
    print(f"saved policy params to {args.save_path}")

    result = dict(mse=mse, epochs_per_s=epochs_per_s, eval_success=None)
    env_id = args.env_id or (meta["env_info"]["env_id"] if meta else None)
    if env_id:
        import maniskill_tpu_torch.envs  # noqa: F401
        from maniskill_tpu_torch import make

        ek = dict(meta["env_info"].get("env_kwargs", {})) if meta else {}
        ek.pop("num_envs", None)
        ek.setdefault("obs_mode", "state")
        env = make(env_id, num_envs=args.num_eval_envs, device=dev, **ek)
        obs, _ = env.reset(seed=args.seed + 1)
        success = torch.zeros(args.num_eval_envs, dtype=torch.bool, device=dev)
        with torch.no_grad():
            for _ in range(args.eval_steps):
                obs, rew, term, trunc, info = env.step(policy(obs))
                success |= info.get("success", term)
        result["eval_success"] = float(success.float().mean())
        print(f"eval success(any): {result['eval_success']}")
        env.close()
    return result


if __name__ == "__main__":
    main()
