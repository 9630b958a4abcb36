"""TD-MPC2 on a batched env (counterpart of maniskill_tpu/parallel/tdmpc2.py).

A latent world model (encoder, dynamics, reward head, an ensemble of Q heads
with an EMA target), a squashed-Gaussian policy prior, and the MPPI planner
that acts with them; ``TDMPC2Trainer`` is the counterpart of
``make_tdmpc2_step``'s ``init_state``, ``train_step`` and ``act``. The replay
ring lives on the env's device as (buffer_steps, num_envs, dim) tensors and
holds whole fixed-length episodes (terminations are ignored), so sampled
subsequences never cross an episode.

The planner is batched over (envs, samples): each latent rollout is one
matrix product per layer over envs x samples rows, and the Q ensemble keeps
its heads' weights stacked (num_q, in, out), as flax's ``nn.vmap`` stores
them, so one batched product serves every head. The networks stay in
float32 (TF32 is off, ``physics/types.py``).

Every draw comes from the trainer's ``torch.Generator`` on the env's device,
and the functions that draw also take their draws as tensors (``plan``,
``update_once``), so a test can feed them the JAX package's draws. ``ptr``
and ``filled`` are host ints, so a train step reads nothing back.
"""
from __future__ import annotations

import copy
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..utils.common import top_k_stable
from ..utils.gym_utils import find_max_episode_steps_value
from .sac import ema_
from .train import LOG_2PI, _flax_dense_init, _lecun_normal_, clip_by_global_norm_, make_env_step_fns, \
    params_from_flax, params_to_flax


class TDMPC2Config(NamedTuple):
    # planning
    mpc: bool = True
    horizon: int = 3
    num_samples: int = 512
    num_elites: int = 64
    num_pi_trajs: int = 24
    iterations: int = 6
    temperature: float = 0.5
    min_std: float = 0.05
    max_std: float = 2.0
    # architecture
    latent_dim: int = 512
    simnorm_dim: int = 8
    enc_dim: int = 256
    num_enc_layers: int = 2
    mlp_dim: int = 512
    num_q: int = 5
    dropout: float = 0.01
    # discrete regression
    num_bins: int = 101
    vmin: float = -10.0
    vmax: float = 10.0
    # optimization
    lr: float = 3e-4
    enc_lr_scale: float = 0.3
    grad_clip_norm: float = 20.0
    tau: float = 0.01
    rho: float = 0.5
    consistency_coef: float = 20.0
    reward_coef: float = 0.1
    value_coef: float = 0.1
    entropy_coef: float = 1e-4
    log_std_min: float = -10.0
    log_std_max: float = 2.0
    # training loop
    rollout_steps: int = 4
    buffer_steps: int = 1024
    batch_size: int = 256
    num_updates: int = 2  # gradient updates per train_step
    # discount heuristic
    discount_denom: float = 5.0
    discount_min: float = 0.95
    discount_max: float = 0.995


# ---------------------------------------------------------------------------
# math: symlog two-hot regression
# ---------------------------------------------------------------------------

def symlog(x):
    return torch.sign(x) * torch.log1p(torch.abs(x))


def symexp(x):
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


def two_hot(x, cfg: TDMPC2Config):
    """Scalar -> soft two-hot target over symlog-spaced bins: (...,) ->
    (..., num_bins). The upper bin wraps (``(idx + 1) % num_bins``) as the
    reference's does; its weight is 0 there."""
    bin_size = (cfg.vmax - cfg.vmin) / (cfg.num_bins - 1)
    x = torch.clamp(symlog(x), cfg.vmin, cfg.vmax)
    idx = torch.floor((x - cfg.vmin) / bin_size)
    off = (x - cfg.vmin) / bin_size - idx
    idx = idx.to(torch.int64)
    bins = torch.arange(cfg.num_bins, device=x.device)
    lo = (bins == idx[..., None]) * (1.0 - off)[..., None]
    hi = (bins == ((idx + 1) % cfg.num_bins)[..., None]) * off[..., None]
    return lo + hi


def two_hot_inv(logits, cfg: TDMPC2Config):
    """Soft two-hot logits -> scalar: (..., num_bins) -> (...,)."""
    bins = torch.linspace(cfg.vmin, cfg.vmax, cfg.num_bins, device=logits.device)
    return symexp(torch.sum(torch.softmax(logits, -1) * bins, -1))


def soft_ce(logits, target, cfg: TDMPC2Config):
    """Cross entropy against the two-hot encoding of the scalar target."""
    return -torch.sum(two_hot(target, cfg) * torch.log_softmax(logits, -1), -1)


def simnorm(x, dim: int):
    """Simplicial normalization: a softmax over groups of ``dim``."""
    shp = x.shape
    return torch.softmax(x.reshape(shp[:-1] + (shp[-1] // dim, dim)), -1).reshape(shp)


# ---------------------------------------------------------------------------
# networks
# ---------------------------------------------------------------------------

class StackedLinear(nn.Module):
    """``n`` independent dense layers with stacked weights (n, in, out): one
    batched product over (n, rows, in)."""

    def __init__(self, n: int, in_features: int, out_features: int, generator: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(n, out_features))
        with torch.no_grad():
            _lecun_normal_(self.weight, in_features, generator)

    def forward(self, x):
        return torch.baddbmm(self.bias[:, None], x, self.weight)


class StackedLayerNorm(nn.Module):
    def __init__(self, n: int, features: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n, features))
        self.bias = nn.Parameter(torch.zeros(n, features))
        self.eps = eps

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], eps=self.eps) * self.weight[:, None] + self.bias[:, None]


class NormedLinear(nn.Module):
    """Linear -> LayerNorm (eps 1e-6, flax's default) -> dropout -> mish;
    with ``heads`` n, n of them at once over (n, rows, in), their weights
    stacked."""

    def __init__(self, in_features: int, out_features: int, generator: torch.Generator, dropout: float = 0.0,
                 heads: Optional[int] = None):
        super().__init__()
        if heads is None:
            self.linear = nn.Linear(in_features, out_features)
            _flax_dense_init(self.linear, generator)
            self.norm = nn.LayerNorm(out_features, eps=1e-6)
        else:
            self.linear = StackedLinear(heads, in_features, out_features, generator)
            self.norm = StackedLayerNorm(heads, out_features, eps=1e-6)
        self.dropout = dropout

    def forward(self, x, keep: Optional[torch.Tensor] = None):
        x = self.norm(self.linear(x))
        if keep is not None:  # flax's Dropout: kept entries scaled by 1 / keep_prob
            x = torch.where(keep, x / (1.0 - self.dropout), 0.0)
        return F.mish(x)


class _MLPHead(nn.Module):
    """NormedLinear layers, then a dense ``out``."""

    def __init__(self, dims, out_features: int, generator: torch.Generator):
        super().__init__()
        self.layers = nn.ModuleList([NormedLinear(a, b, generator) for a, b in zip(dims[:-1], dims[1:])])
        self.out = nn.Linear(dims[-1], out_features)
        _flax_dense_init(self.out, generator)

    def trunk(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class Encoder(_MLPHead):
    def __init__(self, obs_dim: int, cfg: TDMPC2Config, generator: torch.Generator):
        super().__init__([obs_dim] + [cfg.enc_dim] * cfg.num_enc_layers, cfg.latent_dim, generator)
        self.simnorm_dim = cfg.simnorm_dim

    def forward(self, obs):
        return simnorm(self.out(self.trunk(obs)), self.simnorm_dim)


class Dynamics(_MLPHead):
    def __init__(self, act_dim: int, cfg: TDMPC2Config, generator: torch.Generator):
        super().__init__([cfg.latent_dim + act_dim, cfg.mlp_dim, cfg.mlp_dim], cfg.latent_dim, generator)
        self.simnorm_dim = cfg.simnorm_dim

    def forward(self, z, a):
        return simnorm(self.out(self.trunk(torch.cat([z, a], -1))), self.simnorm_dim)


class RewardHead(_MLPHead):
    def __init__(self, act_dim: int, cfg: TDMPC2Config, generator: torch.Generator):
        super().__init__([cfg.latent_dim + act_dim, cfg.mlp_dim, cfg.mlp_dim], cfg.num_bins, generator)

    def forward(self, z, a):
        return self.out(self.trunk(torch.cat([z, a], -1)))


class QEnsemble(nn.Module):
    """``num_q`` two-hot Q heads (NormedLinear with dropout, NormedLinear,
    dense) with stacked weights; (..., L), (..., A) -> (num_q, ..., bins)."""

    def __init__(self, act_dim: int, cfg: TDMPC2Config, generator: torch.Generator):
        super().__init__()
        n, mlp = cfg.num_q, cfg.mlp_dim
        self.layers = nn.ModuleList([
            NormedLinear(cfg.latent_dim + act_dim, mlp, generator, dropout=cfg.dropout, heads=n),
            NormedLinear(mlp, mlp, generator, heads=n),
        ])
        self.out = StackedLinear(n, mlp, cfg.num_bins, generator)

    def forward(self, z, a, keep: Optional[torch.Tensor] = None):
        """``keep``: the first layer's dropout mask (num_q, ..., mlp_dim) in
        training; none in evaluation."""
        x = torch.cat([z, a], -1)
        lead, n = x.shape[:-1], self.out.weight.shape[0]
        x = x.reshape(1, -1, x.shape[-1]).expand(n, -1, -1)
        x = self.layers[0](x, None if keep is None else keep.reshape(n, -1, keep.shape[-1]))
        x = self.out(self.layers[1](x))
        return x.reshape((n,) + lead + x.shape[-1:])


class WorldModel(nn.Module):
    """The reference's ``model_params``: ``enc``, ``dyn``, ``rew``, ``q``."""

    def __init__(self, obs_dim: int, act_dim: int, cfg: TDMPC2Config, seed: int = 0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.enc = Encoder(obs_dim, cfg, g)
        self.dyn = Dynamics(act_dim, cfg, g)
        self.rew = RewardHead(act_dim, cfg, g)
        self.q = QEnsemble(act_dim, cfg, g)


class PolicyPrior(_MLPHead):
    """The mean and log std of a squashed Gaussian over actions, the log
    std squashed into [log_std_min, log_std_max]."""

    def __init__(self, act_dim: int, cfg: TDMPC2Config, seed: int = 0):
        g = torch.Generator().manual_seed(seed)
        super().__init__([cfg.latent_dim, cfg.mlp_dim, cfg.mlp_dim], act_dim, g)
        self.log_std = nn.Linear(cfg.mlp_dim, act_dim)
        _flax_dense_init(self.log_std, g)
        self.log_std_range = (cfg.log_std_min, cfg.log_std_max)

    def forward(self, z):
        x = self.trunk(z)
        lo, hi = self.log_std_range
        return self.out(x), lo + 0.5 * (hi - lo) * (torch.tanh(self.log_std(x)) + 1.0)


def pi_sample(policy: PolicyPrior, z, eps):
    """(tanh(mu), the squashed sample tanh(mu + std * eps), its log-prob,
    log std): the reference's ``_pi_sample`` with its normal draw given."""
    mu, log_std = policy(z)
    act = torch.tanh(mu + torch.exp(log_std) * eps)
    logp = -0.5 * (eps ** 2 + 2 * log_std + LOG_2PI) - torch.log(1.0 - act ** 2 + 1e-6)
    return torch.tanh(mu), act, logp.sum(-1), log_std


def gumbel(shape, generator, device):
    """Standard Gumbel draws, as ``jax.random.gumbel``: -log(-log(u)), u
    uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device).clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


class TDMPC2Trainer:
    """TD-MPC2 state on one env: the world model and its Q target, the
    policy prior, their optimizers (model: encoder gradients x
    ``enc_lr_scale``, global-norm clip, Adam eps 1e-8; policy: clip, Adam eps
    1e-5), the running Q scale, the replay ring and the planner's warm
    start ``prev_mean``."""

    def __init__(self, env, config: TDMPC2Config, obs_dim: int, seed: int = 0):
        base, cfg = env.unwrapped, config
        self.config, self.device, self.num_envs = cfg, base.device, base.num_envs
        self.act_dim = A = int(np.prod(base.single_action_space.shape))
        self.step_fn, self.reset_fn = make_env_step_fns(env)
        self.ep_len = find_max_episode_steps_value(env) or 50
        if cfg.buffer_steps % self.ep_len:
            raise ValueError("the ring must hold whole episodes: buffer_steps % episode length != 0")
        # the reference asserts only the line above; a collect that overran
        # the ring would be clamped there and land on the wrong rows
        if cfg.buffer_steps % cfg.rollout_steps:
            raise ValueError("buffer_steps must be a multiple of rollout_steps")
        if self.ep_len <= cfg.horizon:
            raise ValueError("episodes shorter than the planning horizon")
        frac = self.ep_len / cfg.discount_denom
        self.discount = float(np.clip((frac - 1) / frac, cfg.discount_min, cfg.discount_max))
        self.iterations = cfg.iterations + 2 * int(A >= 20)
        dev = self.device
        self.model = WorldModel(obs_dim, A, cfg, seed).to(dev)
        self.pi = PolicyPrior(A, cfg, seed + 1).to(dev)
        self.q_target = copy.deepcopy(self.model.q).requires_grad_(False)
        self.model_opt = torch.optim.Adam(self.model.parameters(), lr=cfg.lr, eps=1e-8)
        self.pi_opt = torch.optim.Adam(self.pi.parameters(), lr=cfg.lr, eps=1e-5)
        self.q_scale = torch.ones((), device=dev)
        S, B = cfg.buffer_steps, self.num_envs
        self.buf_obs = torch.zeros(S, B, obs_dim, device=dev)
        self.buf_act = torch.zeros(S, B, A, device=dev)
        self.buf_rew = torch.zeros(S, B, device=dev)
        self.ptr = 0
        self.filled = 0
        self.prev_mean = torch.zeros(B, cfg.horizon, A, device=dev)
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed)
        # constants on the device, made once: a tensor built from host
        # values in a train step would be a host-to-device copy
        self.rho = cfg.rho ** torch.arange(cfg.horizon + 1, dtype=torch.float32, device=dev)
        self.percentiles = torch.tensor([0.05, 0.95], device=dev)

    def _randn(self, *shape):
        return torch.randn(shape, generator=self.generator, device=self.device)

    def q_value(self, q: QEnsemble, z, a, mode: str):
        vals = two_hot_inv(q(z, a), self.config)  # (num_q, ...)
        if mode == "min2":
            # the reference takes its first two heads where upstream samples
            # 2 of num_q; mirrored (ROADMAP section 3)
            return torch.amin(vals[:2], 0)
        return vals.mean(0)

    # -- planner ----------------------------------------------------------

    def estimate_value(self, z, actions):
        """z: (B, N, L); actions: (B, H, N, A) -> (B, N): the discounted
        model rewards over the horizon plus the mean Q at the policy's mean
        action (tanh(mu); the reference's sample there is unused)."""
        m, G, disc = self.model, 0.0, 1.0
        for t in range(actions.shape[1]):
            a_t = actions[:, t]
            G = G + disc * two_hot_inv(m.rew(z, a_t), self.config)
            z = m.dyn(z, a_t)
            disc = disc * self.discount
        mu = self.pi.out(self.pi.trunk(z))
        return G + disc * self.q_value(m.q, z, torch.tanh(mu), "avg")

    def draw_plan(self) -> Dict[str, torch.Tensor]:
        """One plan's draws: the policy-prior trajectories' normals
        ``pi_eps`` (H, B, P, A), the samples' ``noise`` (iterations, B, H,
        N - P, A), the Gumbel draws of the elite pick ``gumbel`` (B, E) and
        the exploration normals ``explore`` (B, A)."""
        cfg, B, A = self.config, self.num_envs, self.act_dim
        H, N, P, E = cfg.horizon, cfg.num_samples, cfg.num_pi_trajs, cfg.num_elites
        return dict(pi_eps=self._randn(H, B, P, A), noise=self._randn(self.iterations, B, H, N - P, A),
                    gumbel=gumbel((B, E), self.generator, self.device), explore=self._randn(B, A))

    @torch.no_grad()
    def plan(self, z, t0, prev_mean, eval_mode: bool = False, draws: Optional[Dict[str, torch.Tensor]] = None):
        """MPPI from latents z (B, L), warm started from ``prev_mean`` (B, H,
        A) shifted by a step except where t0 (B,) marks the first step of
        an episode. Returns (action (B, A) in [-1, 1], the new mean)."""
        cfg, m = self.config, self.model
        d = self.draw_plan() if draws is None else draws
        B, L = z.shape
        H, N, P, E = cfg.horizon, cfg.num_samples, cfg.num_pi_trajs, cfg.num_elites

        zp, pi_actions = z[:, None].expand(B, P, L), []
        for t in range(H):
            _, a, _, _ = pi_sample(self.pi, zp, d["pi_eps"][t])
            zp = m.dyn(zp, a)
            pi_actions.append(a)
        pi_actions = torch.stack(pi_actions, 1)  # (B, H, P, A)

        zs = z[:, None].expand(B, N, L)
        shifted = torch.cat([prev_mean[:, 1:], torch.zeros_like(prev_mean[:, :1])], 1)
        mean = torch.where(t0[:, None, None], 0.0, shifted)
        std = torch.full_like(mean, cfg.max_std)
        for i in range(self.iterations):
            sampled = torch.clamp(mean[:, :, None] + std[:, :, None] * d["noise"][i], -1, 1)
            actions = torch.cat([pi_actions, sampled], 2)
            value = torch.nan_to_num(self.estimate_value(zs, actions))  # (B, N)
            elite_val, elite_idx = top_k_stable(value, E)
            elite_actions = torch.take_along_dim(actions, elite_idx[:, None, :, None], 2)  # (B, H, E, A)
            score = torch.softmax(cfg.temperature * (elite_val - elite_val[:, :1]), 1)  # (B, E)
            w = score[:, None, :, None]
            mean = torch.sum(w * elite_actions, 2)
            var = torch.sum(w * (elite_actions - mean[:, :, None]) ** 2, 2)
            std = torch.clamp(torch.sqrt(var), cfg.min_std, cfg.max_std)

        # one elite by score: categorical over log(score) through Gumbel-max
        pick = torch.argmax(d["gumbel"] + torch.log(score + 1e-9), -1)
        a = torch.take_along_dim(elite_actions, pick[:, None, None, None], 2)[:, 0, 0]
        if not eval_mode:
            a = a + std[:, 0] * d["explore"]
        return torch.clamp(a, -1, 1), mean

    @torch.no_grad()
    def act(self, obs, t0, eval_mode: bool = True):
        """The action for ``obs``: the planner's (its mean kept as the next
        warm start), or with ``mpc`` off the policy prior's (its mean in
        evaluation, a sample otherwise)."""
        z = self.model.enc(obs)
        if self.config.mpc:
            a, self.prev_mean = self.plan(z, t0, self.prev_mean, eval_mode=eval_mode)
            return a
        mu, a, _, _ = pi_sample(self.pi, z, self._randn(self.num_envs, self.act_dim))
        return mu if eval_mode else a

    # -- collection ------------------------------------------------------

    def collect(self, obs, elapsed):
        """``rollout_steps`` planner steps into the ring, with fixed-length
        episodes (terminations ignored) reset in the same step. Returns
        (obs, elapsed)."""
        cfg, g = self.config, self.generator
        for t in range(cfg.rollout_steps):
            action = self.act(obs, elapsed == 0, eval_mode=False)
            with torch.no_grad():
                _, reward, _ = self.step_fn(action)
                row = self.ptr + t
                self.buf_obs[row] = obs
                self.buf_act[row] = action
                self.buf_rew[row] = reward
                elapsed = elapsed + 1
                done = elapsed >= self.ep_len
                seeds = torch.randint(0, 2**31, (self.num_envs,), generator=g, device=self.device)
                obs = self.reset_fn(done, seeds)
                elapsed = torch.where(done, 0, elapsed)
        self.ptr = (self.ptr + cfg.rollout_steps) % cfg.buffer_steps
        self.filled = min(self.filled + cfg.rollout_steps, cfg.buffer_steps)
        return obs, elapsed

    # -- update ----------------------------------------------------------

    def draw_update(self) -> Dict[str, torch.Tensor]:
        """One update's draws: the subsequences' episode rows ``ep``,
        offsets ``off`` and envs ``env`` (batch,), the TD target's policy
        normals ``td_eps`` (H, batch, A), the policy loss's ``pi_eps`` (H+1,
        batch, A) and, with dropout, the Q ensemble's ``keep`` mask (num_q,
        H, batch, mlp_dim)."""
        cfg, g, dev = self.config, self.generator, self.device
        b, H = cfg.batch_size, cfg.horizon
        n_ep = max(self.filled // self.ep_len, 1)
        d = dict(ep=torch.randint(0, n_ep, (b,), generator=g, device=dev),
                 off=torch.randint(0, self.ep_len - H, (b,), generator=g, device=dev),
                 env=torch.randint(0, self.num_envs, (b,), generator=g, device=dev),
                 td_eps=self._randn(H, b, self.act_dim), pi_eps=self._randn(H + 1, b, self.act_dim))
        if cfg.dropout > 0:
            u = torch.rand((cfg.num_q, H, b, cfg.mlp_dim), generator=g, device=dev)
            d["keep"] = u < 1.0 - cfg.dropout
        return d

    def sample_seq(self, draws):
        """(H+1)-step subsequences inside one episode row: obs (H+1, b,
        obs_dim), action (H, b, A), reward (H, b)."""
        H = self.config.horizon
        s0 = draws["ep"] * self.ep_len + draws["off"]
        steps = s0[None] + torch.arange(H + 1, device=s0.device)[:, None]  # (H+1, b)
        env = draws["env"][None]
        return self.buf_obs[steps, env], self.buf_act[steps[:-1], env], self.buf_rew[steps[:-1], env]

    def model_loss(self, batch, draws):
        """Consistency + reward + value losses weighted by rho^t. The TD
        target comes from the EMA ensemble's first two heads at the policy
        prior's sampled action. Returns (total, (consistency, reward loss,
        value loss, the latents z_0..z_H))."""
        cfg, m = self.config, self.model
        obs, action, reward = batch
        with torch.no_grad():
            next_z = m.enc(obs[1:])  # (H, b, L)
            _, pi_a, _, _ = pi_sample(self.pi, next_z, draws["td_eps"])
            td_target = reward + self.discount * self.q_value(self.q_target, next_z, pi_a, "min2")

        z0 = m.enc(obs[0])
        z, zs = z0, []
        for t in range(cfg.horizon):
            z = m.dyn(z, action[t])
            zs.append(z)
        zs = torch.stack(zs)  # (H, b, L)
        rho_t = self.rho[:-1]
        consistency = torch.mean(torch.mean((zs - next_z) ** 2, -1) * rho_t[:, None])
        zs_in = torch.cat([z0[None], zs[:-1]], 0)
        reward_loss = torch.mean(soft_ce(m.rew(zs_in, action), reward, cfg) * rho_t[:, None])
        q_logits = m.q(zs_in, action, draws.get("keep"))  # (num_q, H, b, bins)
        value_loss = torch.mean(soft_ce(q_logits, td_target[None], cfg) * rho_t[None, :, None])
        total = cfg.consistency_coef * consistency + cfg.reward_coef * reward_loss + cfg.value_coef * value_loss
        return total, (consistency, reward_loss, value_loss, torch.cat([z0[None], zs], 0))

    def pi_loss(self, zs, eps):
        """The policy's loss on detached latents zs (H+1, b, L) against the
        (updated) model's mean Q over the running scale. Returns (loss, Qs)."""
        cfg = self.config
        _, pis, log_pis, _ = pi_sample(self.pi, zs, eps)
        qs = self.q_value(self.model.q, zs, pis, "avg")  # (H+1, b)
        scale = torch.clamp_min(self.q_scale, 1.0)
        loss = torch.mean(torch.mean(cfg.entropy_coef * log_pis - qs / scale, -1) * self.rho)
        return loss, qs

    def update_once(self, draws: Optional[Dict[str, torch.Tensor]] = None):
        """One model and policy update from ``draws`` (``draw_update()`` by
        default), the Q scale and the EMA target. Leaves each network's
        (scaled, clipped) gradients in ``.grad``; returns (consistency,
        reward, value, policy, total) losses as device scalars."""
        cfg = self.config
        d = self.draw_update() if draws is None else draws
        total, (cl, rl, vl, zs) = self.model_loss(self.sample_seq(d), d)
        self.model_opt.zero_grad(set_to_none=True)
        total.backward()
        # as the reference (tdmpc2.py:539-541): the encoder's gradients are
        # scaled before the clip and Adam, which divides the scale out again,
        # so it acts only through the clip and eps (upstream scales the
        # encoder's learning rate; ROADMAP section 3)
        for p in self.model.enc.parameters():
            p.grad.mul_(cfg.enc_lr_scale)
        params = list(self.model.parameters())
        clip_by_global_norm_(params, cfg.grad_clip_norm)
        self.model_opt.step()

        pl, qs = self.pi_loss(zs.detach(), d["pi_eps"])
        pi_params = list(self.pi.parameters())
        for p, g in zip(pi_params, torch.autograd.grad(pl, pi_params)):
            p.grad = g
        clip_by_global_norm_(pi_params, cfg.grad_clip_norm)
        self.pi_opt.step()

        with torch.no_grad():
            # the running scale: the 5th-95th percentile range of the first
            # step's Qs (linear interpolation, as jnp.percentile)
            lo, hi = torch.quantile(qs[0].detach(), self.percentiles)
            self.q_scale = self.q_scale + cfg.tau * (torch.clamp_min(hi - lo, 1.0) - self.q_scale)
        ema_(self.q_target, self.model.q, cfg.tau)
        return tuple(x.detach() for x in (cl, rl, vl, pl, total))

    def train_step(self, obs, elapsed, learn: bool):
        """One collect and, when ``learn``, ``num_updates`` updates. Returns
        (obs, elapsed, metrics) with the metrics as device tensors."""
        obs, elapsed = self.collect(obs, elapsed)
        if learn:
            losses = [self.update_once() for _ in range(self.config.num_updates)]
            cl, rl, vl, pl, tl = (torch.stack(x).mean() for x in zip(*losses))
        else:
            cl = rl = vl = pl = tl = torch.zeros((), device=self.device)
        return obs, elapsed, dict(consistency_loss=cl, reward_loss=rl, value_loss=vl, pi_loss=pl, total_loss=tl,
                                  q_scale=self.q_scale)


# ----------------------------------------------------------------------------
# weights carried across from and to the JAX package's flax trees
# ----------------------------------------------------------------------------
_LAYER_NAMES = {f"NormedLinear_{i}/{a}": f"layers.{i}.{b}" for i in range(8)
                for a, b in (("Dense_0", "linear"), ("LayerNorm_0", "norm"))}
MLP_NAMES = {**_LAYER_NAMES, "Dense_0": "out"}  # enc, dyn, rew, q
PI_NAMES = {**_LAYER_NAMES, "Dense_0": "out", "Dense_1": "log_std"}
MODEL_PARTS = ("enc", "dyn", "rew", "q")


def model_params_from_flax(tree) -> Dict[str, torch.Tensor]:
    """The reference's ``model_params`` ({"enc", "dyn", "rew", "q"}, each a
    flax parameter tree; q's kernels stacked (num_q, in, out)) -> the state
    dict of ``WorldModel``."""
    return {f"{part}.{k}": v for part in MODEL_PARTS for k, v in params_from_flax(tree[part], MLP_NAMES).items()}


def model_params_to_flax(state_dict) -> dict:
    return {part: params_to_flax({k[len(part) + 1:]: v for k, v in state_dict.items() if k.startswith(part + ".")},
                                 MLP_NAMES) for part in MODEL_PARTS}


def pi_params_from_flax(tree) -> Dict[str, torch.Tensor]:
    return params_from_flax(tree, PI_NAMES)


def pi_params_to_flax(state_dict) -> dict:
    return params_to_flax(state_dict, PI_NAMES)
