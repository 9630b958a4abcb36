"""Soft Actor-Critic on a batched env (counterpart of
maniskill_tpu/parallel/sac.py).

``SACTrainer`` is the counterpart of ``make_sac_step``'s ``init_state`` and
``train_step``: ``rollout_steps`` control steps of the squashed-Gaussian
actor with the same-step masked reset, written into a replay ring on the
env's device ((buffer_steps, num_envs, dim) tensors), then ``utd`` updates,
each in the reference's order: the twin-Q step, the actor's loss on the
*new* Q, the temperature's loss on that loss's log-probs, the EMA of the
target from the new Q. Given ``demos`` (RLPD's recipe) each batch is half
online replay and half demo transitions.

Every draw comes from the trainer's ``torch.Generator`` on the env's device,
and the functions that draw also take their draws as tensors
(``update_once(draws)``), so a test can feed them the JAX package's draws.
``ptr`` and ``filled`` are host ints: they follow from the number of
collects alone, so a train step reads nothing back from the device.

``actor_params_from_flax`` / ``q_params_from_flax`` and their inverses carry
weights between the JAX package's flax trees and these modules.
"""
from __future__ import annotations

import copy
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..utils.gym_utils import find_max_episode_steps_value
from .train import LOG_2PI, _flax_dense_init, make_env_step_fns, params_from_flax, params_to_flax


class TanhGaussianActor(nn.Module):
    """Two ReLU layers, then a mean and a log std (clipped to [-5, 2])."""

    def __init__(self, obs_dim: int, act_dim: int, hidden: int = 256, seed: int = 0):
        super().__init__()
        self.fc0 = nn.Linear(obs_dim, hidden)
        self.fc1 = nn.Linear(hidden, hidden)
        self.mean = nn.Linear(hidden, act_dim)
        self.log_std = nn.Linear(hidden, act_dim)
        g = torch.Generator().manual_seed(seed)
        for layer in (self.fc0, self.fc1, self.mean, self.log_std):
            _flax_dense_init(layer, g)

    def forward(self, x: torch.Tensor):
        x = F.relu(self.fc1(F.relu(self.fc0(x))))
        return self.mean(x), torch.clamp(self.log_std(x), -5.0, 2.0)


class TwinQ(nn.Module):
    """Two independent ReLU MLPs over [obs, act], each to one value."""

    def __init__(self, obs_dim: int, act_dim: int, hidden: int = 256, seed: int = 0):
        super().__init__()

        def mlp():
            return nn.Sequential(nn.Linear(obs_dim + act_dim, hidden), nn.ReLU(), nn.Linear(hidden, hidden),
                                 nn.ReLU(), nn.Linear(hidden, 1))

        self.q1, self.q2 = mlp(), mlp()
        g = torch.Generator().manual_seed(seed)
        for q in (self.q1, self.q2):
            for layer in q[::2]:
                _flax_dense_init(layer, g)

    def forward(self, obs: torch.Tensor, act: torch.Tensor):
        x = torch.cat([obs, act], -1)
        return self.q1(x)[..., 0], self.q2(x)[..., 0]


class SACConfig(NamedTuple):
    rollout_steps: int = 4  # env steps per train_step call
    buffer_steps: int = 512  # ring length (transitions = buffer_steps * num_envs)
    batch_size: int = 4096
    utd: int = 4  # gradient updates per train_step
    gamma: float = 0.9
    tau: float = 0.005
    lr: float = 3e-4
    alpha_lr: float = 3e-4
    ignore_terminations: bool = False


def sample_action(actor: nn.Module, obs: torch.Tensor, eps: torch.Tensor):
    """tanh(mean + std * eps) and its log-prob under the squashed Gaussian
    (the reference's ``_sample_action`` with its normal draw given)."""
    mean, log_std = actor(obs)
    act = torch.tanh(mean + torch.exp(log_std) * eps)
    logp = -0.5 * (eps ** 2 + 2 * log_std + LOG_2PI) - torch.log(1.0 - act ** 2 + 1e-6)
    return act, logp.sum(-1)


def ema_(target: nn.Module, source: nn.Module, tau: float):
    """target <- target * (1 - tau) + source * tau, in place."""
    with torch.no_grad():
        tgt = list(target.parameters())
        torch._foreach_mul_(tgt, 1.0 - tau)
        torch._foreach_add_(tgt, [p * tau for p in source.parameters()])


class SACTrainer:
    """SAC state on one env: actor, twin Q, its EMA target, ``log_alpha``,
    three Adams (eps 1e-8, optax's default) and the replay ring.

    ``demos``: an optional dict(obs, act, rew, next_obs, term) of tensors on
    the env's device, mixed 50/50 into every update batch."""

    def __init__(self, env, config: SACConfig, obs_dim: int, seed: int = 0,
                 demos: Optional[Dict[str, torch.Tensor]] = None):
        base = env.unwrapped
        if config.buffer_steps % config.rollout_steps:
            raise ValueError("buffer_steps must be a multiple of rollout_steps")
        self.config, self.device, self.num_envs = config, base.device, base.num_envs
        self.act_dim = int(np.prod(base.single_action_space.shape))
        self.step_fn, self.reset_fn = make_env_step_fns(env)
        self.max_steps = find_max_episode_steps_value(env) or 50
        self.target_entropy = -float(self.act_dim)
        dev = self.device
        self.actor = TanhGaussianActor(obs_dim, self.act_dim, seed=seed).to(dev)
        self.qnet = TwinQ(obs_dim, self.act_dim, seed=seed + 1).to(dev)
        self.q_target = copy.deepcopy(self.qnet).requires_grad_(False)
        self.log_alpha = torch.zeros((), device=dev, requires_grad=True)
        self.actor_opt = torch.optim.Adam(self.actor.parameters(), lr=config.lr, eps=1e-8)
        self.q_opt = torch.optim.Adam(self.qnet.parameters(), lr=config.lr, eps=1e-8)
        self.alpha_opt = torch.optim.Adam([self.log_alpha], lr=config.alpha_lr, eps=1e-8)
        S, B = config.buffer_steps, self.num_envs
        self.buf_obs = torch.zeros(S, B, obs_dim, device=dev)
        self.buf_act = torch.zeros(S, B, self.act_dim, device=dev)
        self.buf_rew = torch.zeros(S, B, device=dev)
        self.buf_next_obs = torch.zeros(S, B, obs_dim, device=dev)
        self.buf_term = torch.zeros(S, B, dtype=torch.bool, device=dev)
        self.ptr = 0  # next write row on the step axis
        self.filled = 0  # valid rows
        self.demos = demos
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed)

    def _randn(self, *shape):
        return torch.randn(shape, generator=self.generator, device=self.device)

    def collect(self, obs: torch.Tensor, elapsed: torch.Tensor):
        """``rollout_steps`` control steps into the ring; the stored
        ``next_obs`` is the step's obs before the masked reset. Returns
        (obs, elapsed)."""
        cfg, g = self.config, self.generator
        with torch.no_grad():
            for t in range(cfg.rollout_steps):
                action, _ = sample_action(self.actor, obs, self._randn(self.num_envs, self.act_dim))
                next_obs, reward, terminated = self.step_fn(action)
                elapsed = elapsed + 1
                if cfg.ignore_terminations:
                    terminated = torch.zeros_like(terminated)
                done = terminated | ((elapsed >= self.max_steps) & ~terminated)
                row = self.ptr + t
                self.buf_obs[row] = obs
                self.buf_act[row] = action
                self.buf_rew[row] = reward
                self.buf_next_obs[row] = next_obs
                self.buf_term[row] = terminated
                seeds = torch.randint(0, 2**31, (self.num_envs,), generator=g, device=self.device)
                obs = self.reset_fn(done, seeds)
                elapsed = torch.where(done, 0, elapsed)
        self.ptr = (self.ptr + cfg.rollout_steps) % cfg.buffer_steps
        self.filled = min(self.filled + cfg.rollout_steps, cfg.buffer_steps)
        return obs, elapsed

    def draw_update(self) -> Dict[str, torch.Tensor]:
        """One update's draws: replay indices ``idx`` over the filled ring
        (step-major), ``demo_idx`` with demos, and the normal draws of the
        Q target's next action ``eps_q`` and of the actor's ``eps_pi``."""
        cfg, g, dev = self.config, self.generator, self.device
        online = cfg.batch_size // 2 if self.demos is not None else cfg.batch_size
        draws = dict(idx=torch.randint(0, self.filled * self.num_envs, (online,), generator=g, device=dev))
        if self.demos is not None:
            n_demo = self.demos["obs"].shape[0]
            draws["demo_idx"] = torch.randint(0, n_demo, (cfg.batch_size - online,), generator=g, device=dev)
        draws["eps_q"] = self._randn(cfg.batch_size, self.act_dim)
        draws["eps_pi"] = self._randn(cfg.batch_size, self.act_dim)
        return draws

    def batch(self, draws):
        s, b = draws["idx"] // self.num_envs, draws["idx"] % self.num_envs
        batch = (self.buf_obs[s, b], self.buf_act[s, b], self.buf_rew[s, b], self.buf_next_obs[s, b],
                 self.buf_term[s, b].to(torch.float32))
        if self.demos is not None:
            d, di = self.demos, draws["demo_idx"]
            demo = (d["obs"][di], d["act"][di], d["rew"][di], d["next_obs"][di], d["term"][di].to(torch.float32))
            batch = tuple(torch.cat([x, y], 0) for x, y in zip(batch, demo))
        return batch

    def update_once(self, draws: Optional[Dict[str, torch.Tensor]] = None):
        """One update from ``draws`` (``draw_update()`` by default). Leaves
        each network's gradient of its loss in ``.grad``; returns (q_loss,
        actor_loss) as device scalars."""
        cfg = self.config
        draws = self.draw_update() if draws is None else draws
        obs, act, rew, next_obs, term = self.batch(draws)

        with torch.no_grad():
            next_act, next_logp = sample_action(self.actor, next_obs, draws["eps_q"])
            tq1, tq2 = self.q_target(next_obs, next_act)
            target = rew + cfg.gamma * (1.0 - term) * (torch.minimum(tq1, tq2) - torch.exp(self.log_alpha) * next_logp)
        q1, q2 = self.qnet(obs, act)
        q_loss = torch.mean((q1 - target) ** 2 + (q2 - target) ** 2)
        self.q_opt.zero_grad(set_to_none=True)
        q_loss.backward()
        self.q_opt.step()

        # the actor against the updated Q; only the actor's gradients
        pi_act, logp = sample_action(self.actor, obs, draws["eps_pi"])
        q1, q2 = self.qnet(obs, pi_act)
        actor_loss = torch.mean(torch.exp(self.log_alpha.detach()) * logp - torch.minimum(q1, q2))
        params = list(self.actor.parameters())
        for p, g in zip(params, torch.autograd.grad(actor_loss, params)):
            p.grad = g
        self.actor_opt.step()

        alpha_loss = -torch.mean(torch.exp(self.log_alpha) * (logp.detach() + self.target_entropy))
        self.alpha_opt.zero_grad(set_to_none=True)
        alpha_loss.backward()
        self.alpha_opt.step()

        ema_(self.q_target, self.qnet, cfg.tau)
        return q_loss.detach(), actor_loss.detach()

    def train_step(self, obs: torch.Tensor, elapsed: torch.Tensor, learn: bool):
        """One collect and, when ``learn``, ``utd`` updates. Returns (obs,
        elapsed, metrics) with the metrics as device tensors."""
        obs, elapsed = self.collect(obs, elapsed)
        if learn:
            losses = [self.update_once() for _ in range(self.config.utd)]
            q_loss, actor_loss = (torch.stack(x).mean() for x in zip(*losses))
        else:
            q_loss = actor_loss = torch.zeros((), device=self.device)
        return obs, elapsed, dict(q_loss=q_loss, actor_loss=actor_loss, alpha=torch.exp(self.log_alpha.detach()))


EVAL_STEPS = 60  # the reference CLI's greedy evaluation


@torch.no_grad()
def evaluate(env, actor: nn.Module, seed: int, steps: int = EVAL_STEPS):
    """Reset with ``seed`` and act greedily (tanh(mean)) for ``steps``
    control steps with no auto-reset. Returns (the (num_envs,) bool tensor
    of envs that succeeded at least once, the mean reward), on the device."""
    base = env.unwrapped
    obs, _ = env.reset(seed=seed)
    success = torch.zeros(base.num_envs, dtype=torch.bool, device=base.device)
    rew_sum = torch.zeros((), device=base.device)
    for _ in range(steps):
        mean, _ = actor(obs)
        obs, rew, term, _, info = env.step(torch.tanh(mean))
        success |= info.get("success", term)
        rew_sum += rew.mean()
    return success, rew_sum / steps


# ----------------------------------------------------------------------------
# weights carried across from and to the JAX package's flax trees (flax
# auto-names the Dense layers in construction order)
# ----------------------------------------------------------------------------
ACTOR_NAMES = {"Dense_0": "fc0", "Dense_1": "fc1", "Dense_2": "mean", "Dense_3": "log_std"}
Q_NAMES = {"Dense_0": "q1.0", "Dense_1": "q1.2", "Dense_2": "q1.4",
           "Dense_3": "q2.0", "Dense_4": "q2.2", "Dense_5": "q2.4"}


def actor_params_from_flax(tree):
    return params_from_flax(tree, ACTOR_NAMES)


def actor_params_to_flax(state_dict) -> dict:
    return params_to_flax(state_dict, ACTOR_NAMES)


def q_params_from_flax(tree):
    return params_from_flax(tree, Q_NAMES)


def q_params_to_flax(state_dict) -> dict:
    return params_to_flax(state_dict, Q_NAMES)
