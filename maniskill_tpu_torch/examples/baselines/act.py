"""ACT baseline CLI (counterpart of maniskill_tpu/examples/baselines/act.py,
after Zhao et al. 2023).

A CVAE action-chunking transformer: a style latent z is inferred from the
(state, action chunk) pair at training time (KL-regularized to N(0, 1)) and
set to zero at inference; a transformer decoder maps [z, obs] and H learned
query tokens to an H-step action chunk. ``--temporal-agg`` averages the
overlapping chunks' predictions of each step with weights exp(-0.01 i).

The layers are the JAX package's flax ones: pre-LayerNorm blocks (eps 1e-6)
with flax's multi-head attention (per-head q/k/v projections, the query
scaled by 1/sqrt(head_dim), a plain softmax in float32) and a tanh-gelu MLP,
trained on L1 + kl_weight * KL under AdamW (weight decay 1e-4 on every
parameter, as optax's unmasked ``adamw``). The permutation and z's noise are
tensors from one ``torch.Generator`` on the device, which ``epoch_step`` also
takes as arguments. Runs on the card unless ``--device cpu`` is given.

Usage:
    python -m maniskill_tpu_torch.examples.baselines.act \\
        --traj-path demos.h5 --env-id PickCube-v1 --epochs 500 [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import List, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .bc import _flatten_obs
from .diffusion_policy import _dense, carry_from_flax, carry_to_flax

EVAL_STEPS = 50  # the reference CLI's evaluation horizon
TEMPORAL_DECAY = 0.01


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--traj-path", required=True)
    p.add_argument("--env-id", default=None)
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--dim", type=int, default=256)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--layers", type=int, default=3)
    p.add_argument("--latent-dim", type=int, default=32)
    p.add_argument("--horizon", type=int, default=8)
    p.add_argument("--kl-weight", type=float, default=10.0)
    p.add_argument("--eval-episodes", type=int, default=16)
    p.add_argument("--temporal-agg", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def load_dataset(traj_path: str, horizon: int):
    """The JAX CLI's training set: (X (N, D) obs_t, Y (N, H, A) the chunk of
    actions t..t+H-1, the last action repeated past the episode's end)."""
    from maniskill_tpu_torch.trajectory.dataset import ManiSkillTrajectoryDataset

    H = horizon
    ds = ManiSkillTrajectoryDataset(traj_path)
    OBS, CHUNK = [], []
    for ep in range(len(ds.actions)):
        acts = np.asarray(ds.actions[ep], np.float32)
        batched = acts.ndim == 3
        obs = _flatten_obs(ds.obs[ep], 2 if batched else 1)
        for b in (range(acts.shape[1]) if batched else [None]):
            o = obs[:, b] if batched else obs
            a = acts[:, b] if batched else acts
            T = len(a)
            for t in range(T):
                OBS.append(o[t])
                CHUNK.append(np.stack([a[min(t + i, T - 1)] for i in range(H)]))
    ds.close()
    return np.stack(OBS), np.stack(CHUNK)


class Attention(nn.Module):
    """flax's ``MultiHeadDotProductAttention`` (self-attention, no mask, no
    dropout): q/k/v projections to (heads, head_dim), the query scaled by
    1/sqrt(head_dim), softmax over the keys, the output projection."""

    def __init__(self, dim: int, heads: int, g: torch.Generator):
        super().__init__()
        self.heads = heads
        self.query, self.key, self.value, self.out = (_dense(dim, dim, g) for _ in range(4))

    def forward(self, x):
        B, L, D = x.shape
        q, k, v = (layer(x).reshape(B, L, self.heads, -1).transpose(1, 2) for layer in (self.query, self.key, self.value))
        q = q / float(np.sqrt(np.float32(q.shape[-1])))  # flax's f32 sqrt of the head dim
        w = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        return self.out((w @ v).transpose(1, 2).reshape(B, L, D))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, g: torch.Generator):
        super().__init__()
        self.norm0 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads, g)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.fc0 = _dense(dim, 4 * dim, g)
        self.fc1 = _dense(4 * dim, dim, g)

    def forward(self, x):
        x = x + self.attn(self.norm0(x))
        return x + self.fc1(F.gelu(self.fc0(self.norm1(x)), approximate="tanh"))


class ACT(nn.Module):
    """forward(obs (B, D), chunk (B, H, A) or None, z_noise (B, latent) or
    None) -> (chunk prediction (B, H, A), mu, logvar); with no chunk (the
    inference path) z = mu = logvar = 0."""

    def __init__(self, obs_dim: int, act_dim: int, horizon: int = 8, dim: int = 256, heads: int = 4,
                 layers: int = 3, latent_dim: int = 32, seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.horizon, self.latent_dim = horizon, latent_dim
        self.enc_obs, self.enc_act = _dense(obs_dim, dim, g), _dense(act_dim, dim, g)
        self.enc_pos = nn.Parameter(0.02 * torch.randn((1, 1 + horizon, dim), generator=g))
        self.enc = nn.ModuleList([Block(dim, heads, g) for _ in range(layers)])
        self.enc_z = _dense(dim, 2 * latent_dim, g)
        self.query = nn.Parameter(0.02 * torch.randn((1, horizon, dim), generator=g))
        self.dec_z, self.dec_obs = _dense(latent_dim, dim, g), _dense(obs_dim, dim, g)
        self.dec = nn.ModuleList([Block(dim, heads, g) for _ in range(layers)])
        self.head = _dense(dim, act_dim, g)

    def forward(self, obs, chunk=None, z_noise=None):
        B = obs.shape[0]
        if chunk is not None:
            toks = torch.cat([self.enc_obs(obs)[:, None], self.enc_act(chunk)], 1) + self.enc_pos
            for block in self.enc:
                toks = block(toks)
            stats = self.enc_z(toks[:, 0])
            mu, logvar = stats[:, :self.latent_dim], stats[:, self.latent_dim:]
            z = mu + torch.exp(0.5 * logvar) * z_noise
        else:
            mu = logvar = z = torch.zeros(B, self.latent_dim, device=obs.device)
        toks = torch.cat([self.dec_z(z)[:, None], self.dec_obs(obs)[:, None],
                          self.query.expand(B, -1, -1)], 1)
        for block in self.dec:
            toks = block(toks)
        return self.head(toks[:, 2:]), mu, logvar


def act_layout(model: ACT) -> List[Tuple]:
    """The rows of ``carry_from_flax`` for the JAX CLI's ``ACT``."""
    rows = [(n, n, "dense") for n in ("enc_obs", "enc_act", "enc_z", "dec_z", "dec_obs", "head")]
    rows += [("enc_pos", "enc_pos", "param"), ("query", "query", "param")]
    for side in ("enc", "dec"):
        for i, block in enumerate(getattr(model, side)):
            t, f = f"{side}.{i}", f"{side}_{i}"
            heads = block.attn.heads
            rows += [(f"{t}.norm0", f"{f}/LayerNorm_0", "norm"), (f"{t}.norm1", f"{f}/LayerNorm_1", "norm"),
                     (f"{t}.fc0", f"{f}/Dense_0", "dense"), (f"{t}.fc1", f"{f}/Dense_1", "dense"),
                     (f"{t}.attn.out", f"{f}/MultiHeadDotProductAttention_0/out", ("heads_out", heads))]
            rows += [(f"{t}.attn.{p}", f"{f}/MultiHeadDotProductAttention_0/{p}", ("heads_in", heads))
                     for p in ("query", "key", "value")]
    return rows


def params_from_flax(tree, model: ACT):
    return carry_from_flax(tree, act_layout(model))


def params_to_flax(model: ACT) -> dict:
    return carry_to_flax(model.state_dict(), act_layout(model))


def draw_epoch(generator: torch.Generator, n: int, batch_size: int, latent_dim: int):
    """One epoch's draws: the permutation and z's noise (nb, bs, latent)."""
    dev = generator.device
    bs = min(batch_size, n)
    nb = max(1, n // bs)
    return dict(perm=torch.randperm(n, generator=generator, device=dev),
                z_noise=torch.randn((nb, bs, latent_dim), generator=generator, device=dev))


def epoch_step(model: ACT, opt, X, Y, kl_weight: float, draws) -> torch.Tensor:
    """One pass: per minibatch the L1 of the chunk plus kl_weight times the
    KL to N(0, 1), one AdamW step. Returns the mean loss as a device
    scalar."""
    perm, z_noise = draws["perm"], draws["z_noise"]
    bs = z_noise.shape[1]
    losses = []
    for i in range(z_noise.shape[0]):
        idx = perm[i * bs:(i + 1) * bs]
        obs, chunk = X[idx], Y[idx]
        pred, mu, logvar = model(obs, chunk, z_noise[i])
        l1 = torch.mean(torch.abs(pred - chunk))
        kl = -0.5 * torch.mean(1 + logvar - mu ** 2 - torch.exp(logvar))
        loss = l1 + kl_weight * kl
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return torch.stack(losses).mean()


def temporal_weights(t: int, horizon: int) -> np.ndarray:
    """The weights of the chunks predicted at steps t, t-1, ... that cover
    step t: exp(-0.01 i) for i < min(t + 1, H)."""
    return np.array([np.exp(-TEMPORAL_DECAY * i) for i in range(min(t + 1, horizon))])


def temporal_ensemble(preds: torch.Tensor, t: int) -> torch.Tensor:
    """The action at step t from ``preds`` (steps, B, H, A), where preds[s]
    is the chunk predicted at step s: the weighted mean of preds[t - i][:, i]."""
    H = preds.shape[2]
    ws = temporal_weights(t, H)
    acts = torch.stack([preds[t - i][:, i] for i in range(len(ws))])
    w = torch.as_tensor(ws / ws.sum(), dtype=acts.dtype, device=acts.device)
    return torch.tensordot(w, acts, dims=1)


@torch.no_grad()
def evaluate(env, model: ACT, temporal_agg: bool, seed: int = 123) -> torch.Tensor:
    """The reference's 50-step eval from ``env.reset(seed)``: whole chunks,
    or with ``temporal_agg`` one ensembled action per step. Returns the
    (num_envs,) bool tensor of envs that succeeded at least once."""
    base = env.unwrapped
    obs, _ = env.reset(seed=seed)
    success = torch.zeros(base.num_envs, dtype=torch.bool, device=base.device)
    H = model.horizon
    if temporal_agg:
        preds = None
        for t in range(EVAL_STEPS):
            chunk = model(obs)[0]
            if preds is None:
                preds = torch.zeros((EVAL_STEPS + H,) + chunk.shape, device=chunk.device)
            preds[t] = chunk
            obs, rew, term, trunc, info = env.step(temporal_ensemble(preds, t))
            success |= info["success"]
    else:
        for _ in range(0, EVAL_STEPS, H):
            chunk = model(obs)[0]
            for k in range(H):
                obs, rew, term, trunc, info = env.step(chunk[:, k])
                success |= info["success"]
    return success


def main(argv=None):
    """Returns dict(loss=[per epoch], epochs_per_s, model, epoch (a callable
    that trains one more epoch and returns its mean loss on the device),
    eval_success: None without --env-id, and with it the eval's env)."""
    args = parse_args(argv)
    dev = torch.device(args.device)
    H = args.horizon
    X_np, Y_np = load_dataset(args.traj_path, H)
    A = Y_np.shape[-1]
    print(f"dataset: {X_np.shape[0]} samples, obs {X_np.shape[1]}, chunk {H}x{A}")

    model = ACT(X_np.shape[1], A, H, args.dim, args.heads, args.layers, args.latent_dim, seed=args.seed).to(dev)
    opt = torch.optim.AdamW(model.parameters(), lr=args.lr, eps=1e-8, weight_decay=1e-4)
    X, Y = torch.as_tensor(X_np, device=dev), torch.as_tensor(Y_np, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)

    def epoch():
        return epoch_step(model, opt, X, Y, args.kl_weight, draw_epoch(g, X.shape[0], args.batch_size, args.latent_dim))

    losses = []
    t0 = time.time()
    for e in range(args.epochs):
        losses.append(epoch())
        if e % max(1, args.epochs // 10) == 0 or e == args.epochs - 1:
            print(f"epoch {e}/{args.epochs} loss {float(losses[-1]):.5f} ({time.time() - t0:.1f}s)", flush=True)
    losses = [float(x) for x in losses]
    out = dict(loss=losses, epochs_per_s=args.epochs / max(time.time() - t0, 1e-9), model=model, epoch=epoch,
               eval_success=None)
    if args.env_id:
        import maniskill_tpu_torch.envs  # noqa: F401
        from maniskill_tpu_torch import make

        env = make(args.env_id, num_envs=args.eval_episodes, obs_mode="state", device=dev)
        success = evaluate(env, model, args.temporal_agg)
        out.update(eval_success=float(success.float().mean()), env=env)
        print(f"eval success_once: {out['eval_success']:.3f}")
    return out


if __name__ == "__main__":
    main()
