"""PPO on a batched env (counterpart of maniskill_tpu/parallel/train.py).

``PPOTrainer`` is the counterpart of ``make_train_step``'s ``init_state`` and
``train_step``: a rollout with the same-step masked reset and the
``V(final_obs)`` bootstrap at every episode boundary, ``compute_gae``,
``ppo_loss`` and the minibatch epochs, for state obs (``ActorCritic``) and
visual obs (``VisualActorCritic`` over a NatureCNN whose convolutions run in
bfloat16, as the reference's do). Everything stays on the env's device: the
action noise, the minibatch permutations and the reset seeds come from one
``torch.Generator`` on that device, and no value is read back to the host
inside an iteration (the metrics are tensors until the caller reads them).

``params_from_flax`` / ``params_to_flax`` carry weights between the JAX
package's flax parameter trees and these modules' state dicts, so a
checkpoint pickled by either package loads into the other
(``load_jax_checkpoint``, ``save_checkpoint``).
"""
from __future__ import annotations

import math
import pickle
from collections import OrderedDict
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..utils import common
from ..utils.gym_utils import find_max_episode_steps_value

LOG_2PI = math.log(2 * math.pi)


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator):
    """flax's lecun_normal: a normal truncated at two standard deviations,
    of variance 1/fan_in after the truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


def _flax_dense_init(layer: nn.Linear, generator: torch.Generator, scale: Optional[float] = None):
    """flax's Dense defaults (a lecun_normal kernel, or with ``scale`` an
    orthogonal one of that gain; zero bias)."""
    with torch.no_grad():
        if scale is None:
            _lecun_normal_(layer.weight, layer.in_features, generator)
        else:
            nn.init.orthogonal_(layer.weight, gain=scale, generator=generator)
        layer.bias.zero_()


def _flax_conv_init(conv: nn.Conv2d, generator: torch.Generator):
    with torch.no_grad():
        _lecun_normal_(conv.weight, conv.in_channels * conv.kernel_size[0] * conv.kernel_size[1], generator)
        conv.bias.zero_()


class ActorCritic(nn.Module):
    """Separate tanh MLP trunks for the policy mean and the value; a learned
    state-independent log std, clipped to [-4, 1]."""

    def __init__(self, obs_dim: int, action_dim: int, hidden: int = 256, seed: int = 0):
        super().__init__()
        self.actor = nn.Sequential(nn.Linear(obs_dim, hidden), nn.Tanh(), nn.Linear(hidden, hidden), nn.Tanh())
        self.actor_mean = nn.Linear(hidden, action_dim)
        self.critic = nn.Sequential(nn.Linear(obs_dim, hidden), nn.Tanh(), nn.Linear(hidden, hidden), nn.Tanh())
        self.value_head = nn.Linear(hidden, 1)
        self.log_std = nn.Parameter(torch.full((action_dim,), -0.5))
        g = torch.Generator().manual_seed(seed)
        for layer in (self.actor[0], self.actor[2], self.critic[0], self.critic[2], self.value_head):
            _flax_dense_init(layer, g)
        _flax_dense_init(self.actor_mean, g, scale=0.01)

    def forward(self, x: torch.Tensor):
        mean = self.actor_mean(self.actor(x))
        log_std = torch.clamp(self.log_std, -4.0, 1.0)  # guard against std collapse/blowup
        return mean, log_std, self.value_head(self.critic(x))[..., 0]


class NatureCNN(nn.Module):
    """NatureCNN towers over the image obs (three VALID convolutions and a
    dense layer each, all in bfloat16, the frames taken NHWC and the feature
    map flattened in NHWC order as the reference's weights expect) beside a
    float32 dense layer over the state vector. A tower is built for each of
    ``rgb`` and ``rgbd`` (scaled by 1/255) and ``depth`` (int16 mm scaled to
    metres) whose shape is given; the features are concatenated in the
    reference's order: rgb, rgbd, depth, state."""

    IMAGE_KEYS = ("rgb", "rgbd", "depth")
    CONVS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))  # (channels, kernel, stride)

    def __init__(self, rgb_shape=None, state_dim: Optional[int] = None, feature_size: int = 256, seed: int = 0,
                 depth_shape=None, rgbd_shape=None):
        super().__init__()
        shapes = dict(rgb=rgb_shape, rgbd=rgbd_shape, depth=depth_shape)
        self.image_keys = tuple(k for k in self.IMAGE_KEYS if shapes[k] is not None)
        g = torch.Generator().manual_seed(seed)
        for key in self.image_keys:
            h, w, c = shapes[key]
            for ch, k, s in self.CONVS:
                conv = nn.Conv2d(c, ch, k, stride=s)
                _flax_conv_init(conv, g)
                self.add_module(f"{key}_conv{k}", conv)
                h, w, c = (h - k) // s + 1, (w - k) // s + 1, ch
            fc = nn.Linear(c * h * w, feature_size)
            _flax_dense_init(fc, g)
            self.add_module(f"{key}_fc", fc)
        self.out_features = feature_size * len(self.image_keys)
        if state_dim is not None:
            self.state_fc = nn.Linear(state_dim, 256)
            _flax_dense_init(self.state_fc, g)
            self.out_features += 256

    def forward(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        # flax's bf16 layers: inputs and parameters cast to bf16, the product
        # rounded to bf16, then the bias added in bf16
        bf16 = torch.bfloat16
        feats = []
        for key in self.image_keys:
            x = (obs[key].to(bf16) / (1000.0 if key == "depth" else 255.0)).permute(0, 3, 1, 2)
            for _, k, _ in self.CONVS:
                conv = getattr(self, f"{key}_conv{k}")
                x = F.relu(F.conv2d(x, conv.weight.to(bf16), stride=conv.stride) + conv.bias.to(bf16)[:, None, None])
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
            fc = getattr(self, f"{key}_fc")
            feats.append(F.relu(F.linear(x, fc.weight.to(bf16)) + fc.bias.to(bf16)).to(torch.float32))
        if hasattr(self, "state_fc"):
            feats.append(self.state_fc(obs["state"]))
        return torch.cat(feats, -1)


class VisualActorCritic(nn.Module):
    """A shared NatureCNN encoder, separate ReLU actor and critic heads."""

    def __init__(self, rgb_shape, state_dim: Optional[int], action_dim: int, hidden: int = 512, seed: int = 0,
                 depth_shape=None, rgbd_shape=None):
        super().__init__()
        self.feature_net = NatureCNN(rgb_shape, state_dim, seed=seed, depth_shape=depth_shape, rgbd_shape=rgbd_shape)
        feat = self.feature_net.out_features
        self.actor_fc = nn.Linear(feat, hidden)
        self.actor_out = nn.Linear(hidden, action_dim)
        self.critic_fc = nn.Linear(feat, hidden)
        self.critic_out = nn.Linear(hidden, 1)
        self.log_std = nn.Parameter(torch.full((action_dim,), -0.5))
        g = torch.Generator().manual_seed(seed + 1)
        for layer in (self.actor_fc, self.critic_fc, self.critic_out):
            _flax_dense_init(layer, g)
        _flax_dense_init(self.actor_out, g, scale=0.01 * math.sqrt(2))

    @classmethod
    def for_obs(cls, obs: Dict[str, torch.Tensor], action_dim: int, seed: int = 0) -> "VisualActorCritic":
        """Sized from a transformed obs dict (its image keys and state)."""
        shapes = {k: tuple(obs[k].shape[1:]) for k in NatureCNN.IMAGE_KEYS if k in obs}
        state_dim = obs["state"].shape[-1] if "state" in obs else None
        return cls(shapes.get("rgb"), state_dim, action_dim, seed=seed, depth_shape=shapes.get("depth"),
                   rgbd_shape=shapes.get("rgbd"))

    def forward(self, obs: Dict[str, torch.Tensor]):
        x = self.feature_net(obs)
        mean = self.actor_out(F.relu(self.actor_fc(x)))
        log_std = torch.clamp(self.log_std, -4.0, 1.0)
        v = self.critic_out(F.relu(self.critic_fc(x)))[..., 0]
        return mean, log_std, v


class PPOConfig(NamedTuple):
    rollout_steps: int = 16
    gamma: float = 0.8
    gae_lambda: float = 0.9
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.0
    lr: float = 3e-4
    update_epochs: int = 4
    num_minibatches: int = 4
    max_grad_norm: float = 0.5
    # infinite-horizon mode (ManiSkillVectorEnv's ignore_terminations):
    # success does not end the episode
    ignore_terminations: bool = False


def make_env_step_fns(env, obs_tf=lambda o: o):
    """(step_fn, reset_fn) on the env's own state: ``step_fn(action) -> (obs,
    reward, terminated)`` and ``reset_fn(mask, seeds) -> obs``, with every
    argument and result on the device."""
    base = env.unwrapped

    def step_fn(action):
        obs, reward, terminated, _ = base._step_impl(action)
        return obs_tf(obs), reward, terminated

    def reset_fn(mask, seeds):
        return obs_tf(base._reset_impl(mask, seeds)[0])

    return step_fn, reset_fn


def make_obs_transform(base):
    """A raw visual obs dict -> {"rgb": (B, H, W, 3 x cameras) uint8,
    "depth": (B, H, W, cameras) int16 mm, "state": (B, D) float32} (the
    FlattenRGBDObservationWrapper layout: every camera's frames, cameras
    sorted by name, concatenated on the channels; a key only where the obs
    mode renders it); the identity for state obs."""
    if base.obs_mode in ("state", "none"):
        return lambda obs: obs

    def obs_tf(obs):
        sensors = obs.get("sensor_data", {})
        out = {}
        for key in ("rgb", "depth"):
            frames = [sensors[cam][key] for cam in sorted(sensors) if key in sensors[cam]]
            if frames:
                out[key] = torch.cat(frames, -1)
        out["state"] = common.flatten_state_dict(dict(agent=obs.get("agent", {}), extra=obs.get("extra", {})))
        return out

    return obs_tf


def build_model(base, obs, seed: int = 0) -> nn.Module:
    """The policy for ``base``'s obs mode, sized from a transformed obs, on
    the env's device."""
    act_dim = int(np.prod(base.single_action_space.shape))
    if isinstance(obs, dict):
        model = VisualActorCritic.for_obs(obs, act_dim, seed=seed)
    else:
        model = ActorCritic(obs.shape[-1], act_dim, seed=seed)
    return model.to(base.device)


def gaussian_logp(action, mean, log_std):
    return -0.5 * torch.sum(((action - mean) / torch.exp(log_std)) ** 2 + 2 * log_std + LOG_2PI, -1)


def compute_gae(rewards, dones, values, last_value, gamma: float, gae_lambda: float):
    """(T, B) generalized advantages and returns."""
    not_done = 1.0 - dones.to(torch.float32)
    advs = torch.empty_like(rewards)
    gae, next_value = torch.zeros_like(last_value), last_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * next_value * not_done[t] - values[t]
        gae = delta + gamma * gae_lambda * not_done[t] * gae
        advs[t], next_value = gae, values[t]
    return advs, advs + values


def ppo_loss(model: nn.Module, batch, config: PPOConfig) -> torch.Tensor:
    """Clipped-ratio policy loss + value loss - entropy bonus, with the
    advantages normalized over the minibatch (population std, as jnp.std)."""
    obs, actions, old_logp, advs, returns = batch
    mean, log_std, value = model(obs)
    logp = gaussian_logp(actions, mean, log_std)
    ratio = torch.exp(torch.clamp(logp - old_logp, -20.0, 20.0))
    advs_n = (advs - advs.mean()) / (advs.std(correction=0) + 1e-8)
    pg1 = ratio * advs_n
    pg2 = torch.clamp(ratio, 1 - config.clip_eps, 1 + config.clip_eps) * advs_n
    pg_loss = -torch.mean(torch.minimum(pg1, pg2))
    v_loss = 0.5 * torch.mean((value - returns) ** 2)
    entropy = torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e))
    return pg_loss + config.vf_coef * v_loss - config.ent_coef * entropy


def clip_by_global_norm_(params, max_norm: float):
    """Scale the gradients by max_norm / ||g|| when ||g|| >= max_norm
    (optax.clip_by_global_norm; torch's clip_grad_norm_ adds 1e-6 to the
    norm), with no host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    for g in grads:
        g.mul_(scale)


def _tree_map(fn, x):
    return {k: fn(v) for k, v in x.items()} if isinstance(x, dict) else fn(x)


def _cat_envs(parts, device):
    """(T, B_i, ...) tensors, or dicts of them, joined on the env axis on
    ``device``."""
    if isinstance(parts[0], dict):
        return {k: torch.cat([p[k].to(device) for p in parts], 1) for k in parts[0]}
    return torch.cat([p.to(device) for p in parts], 1)


def _update_metrics(losses, traj, advs, params) -> Dict[str, torch.Tensor]:
    """An update's metrics, as device tensors, from its minibatch losses, the
    trajectory it learned from, its advantages and the parameters after it."""
    t_obs, t_act, _, t_rew, t_done, _, t_term = traj
    obs_leaves = t_obs.values() if isinstance(t_obs, dict) else (t_obs,)
    with torch.no_grad():
        return dict(
            loss=torch.stack(losses).mean(),
            mean_reward=t_rew.mean(),
            # the share of finished episodes that ended by termination
            # (success or fail) rather than truncation
            ep_success=t_term.sum() / torch.clamp(t_done.sum(), min=1),
            bad_params=sum((~torch.isfinite(p)).sum() for p in params),
            bad_rewards=(~torch.isfinite(t_rew)).sum(),
            term_frac=t_term.to(torch.float32).mean(),
            bad_obs=sum((~torch.isfinite(x.to(torch.float32))).sum() for x in obs_leaves),
            max_action=t_act.abs().max(),
            max_adv=advs.abs().max(),
        )


class PPOTrainer:
    """PPO state on one env (counterpart of make_train_step's init_state and
    train_step): the policy, Adam over it with optax's global-norm clip and,
    given ``total_updates``, a linear decay of the learning rate to 0 over
    every minibatch update (the first update takes the full rate)."""

    def __init__(self, env, config: PPOConfig, raw_obs, seed: int = 0, total_updates: Optional[int] = None):
        """``raw_obs``: an obs of ``env`` as its ``reset`` returns it, which
        sizes the policy. ``rollout`` and ``train_step`` take obs in the
        policy's layout: ``obs_tf(raw_obs)``."""
        base = env.unwrapped
        self.config, self.device = config, base.device
        self.num_envs = base.num_envs
        self.obs_tf = make_obs_transform(base)
        self.step_fn, self.reset_fn = make_env_step_fns(env, self.obs_tf)
        self.max_steps = find_max_episode_steps_value(env) or 50
        self.model = build_model(base, self.obs_tf(raw_obs), seed)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=config.lr, eps=1e-8)
        self.scheduler = None
        if total_updates:
            n = total_updates * config.update_epochs * config.num_minibatches
            self.scheduler = torch.optim.lr_scheduler.LambdaLR(self.optimizer, lambda k: 1.0 - min(k, n) / n)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def rollout(self, obs, elapsed: torch.Tensor):
        """``rollout_steps`` control steps of the stochastic policy; envs
        whose episode ends are reset in the same step. Returns (obs,
        elapsed, traj) with traj = (obs, actions, logps, rewards, dones,
        values, terminated), each stacked over time."""
        cfg, model, g = self.config, self.model, self.generator
        steps = []
        with torch.no_grad():
            for _ in range(cfg.rollout_steps):
                mean, log_std, value = model(obs)
                noise = torch.randn(mean.shape, generator=g, device=self.device)
                action = mean + torch.exp(log_std) * noise
                logp = gaussian_logp(action, mean, log_std)
                new_obs, reward, terminated = self.step_fn(action)
                elapsed = elapsed + 1
                if cfg.ignore_terminations:
                    done = elapsed >= self.max_steps
                else:
                    done = terminated | (elapsed >= self.max_steps)
                # bootstrap every episode boundary with V(final obs)
                v_final = model(new_obs)[2]
                reward = reward + cfg.gamma * v_final * done.to(torch.float32)
                seeds = torch.randint(0, 2**31, (self.num_envs,), generator=g, device=self.device)
                reset_obs = self.reset_fn(done, seeds)
                elapsed = torch.where(done, 0, elapsed)
                steps.append((obs, action, logp, reward, done, value, terminated))
                obs = reset_obs
        traj = tuple(
            {k: torch.stack([s[i][k] for s in steps]) for k in steps[0][i]}
            if isinstance(steps[0][i], dict) else torch.stack([s[i] for s in steps])
            for i in range(7)
        )
        return obs, elapsed, traj

    def update(self, obs, traj) -> Dict[str, torch.Tensor]:
        """GAE over ``traj`` (bootstrapped with V(obs)), then the minibatch
        epochs; returns the metrics as device tensors."""
        cfg, model, g = self.config, self.model, self.generator
        t_obs, t_act, t_logp, t_rew, t_done, t_val, t_term = traj
        with torch.no_grad():
            last_value = model(obs)[2]
        advs, returns = compute_gae(t_rew, t_done, t_val, last_value, cfg.gamma, cfg.gae_lambda)
        flat = lambda x: x.reshape((-1,) + x.shape[2:])  # noqa: E731
        batch = (_tree_map(flat, t_obs), flat(t_act), flat(t_logp), flat(advs), flat(returns))
        n = batch[1].shape[0]
        mb_size = n // cfg.num_minibatches
        params = list(model.parameters())
        losses = []
        for _ in range(cfg.update_epochs):
            perm = torch.randperm(n, generator=g, device=self.device)
            for i in range(cfg.num_minibatches):
                idx = perm[i * mb_size:(i + 1) * mb_size]
                mb = (_tree_map(lambda b: b[idx], batch[0]),) + tuple(b[idx] for b in batch[1:])
                loss = ppo_loss(model, mb, cfg)
                self.optimizer.zero_grad(set_to_none=True)
                loss.backward()
                clip_by_global_norm_(params, cfg.max_grad_norm)
                self.optimizer.step()
                if self.scheduler is not None:
                    self.scheduler.step()
                losses.append(loss.detach())
        return _update_metrics(losses, traj, advs, params)

    def train_step(self, obs, elapsed: torch.Tensor):
        """One PPO iteration: rollout, then update. Returns (obs, elapsed,
        metrics)."""
        obs, elapsed, traj = self.rollout(obs, elapsed)
        return obs, elapsed, self.update(obs, traj)


def _ppo_shard_loss(model: nn.Module, batch, weight, adv_mean, adv_std, count: int, config: PPOConfig,
                    with_entropy: bool) -> torch.Tensor:
    """One shard's part of ``ppo_loss`` over a minibatch spread across
    shards: ``weight`` (n,) marks the shard's samples in the minibatch, the
    advantages are normalized with the minibatch's statistics over every
    shard, and the means divide by the minibatch's ``count``; the shards'
    parts sum to ``ppo_loss`` of the whole minibatch (the entropy, a term of
    the parameters alone, is counted on one shard)."""
    obs, actions, old_logp, advs, returns = batch
    mean, log_std, value = model(obs)
    logp = gaussian_logp(actions, mean, log_std)
    ratio = torch.exp(torch.clamp(logp - old_logp, -20.0, 20.0))
    advs_n = (advs - adv_mean) / (adv_std + 1e-8)
    pg1 = ratio * advs_n
    pg2 = torch.clamp(ratio, 1 - config.clip_eps, 1 + config.clip_eps) * advs_n
    pg_loss = -torch.sum(weight * torch.minimum(pg1, pg2)) / count
    v_loss = 0.5 * torch.sum(weight * (value - returns) ** 2) / count
    loss = pg_loss + config.vf_coef * v_loss
    if with_entropy:
        loss = loss - config.ent_coef * torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e))
    return loss


class ShardedPPOTrainer:
    """Data-parallel PPO (counterpart of ``make_sharded_ppo_step``'s sharded
    train step): one ``PPOTrainer`` per device, each over its own env of
    ``num_envs / len(devices)`` envs with a replica of the policy.

    The update is the one ``PPOTrainer`` makes over the whole batch: the
    minibatches are drawn from one permutation of every shard's samples (by
    the first shard's generator, env axis in shard order), each shard weighs
    its samples in the minibatch, the advantage statistics and the loss's
    means are reduced over the shards, and the gradients are summed onto the
    first replica, clipped there and stepped by its Adam; the result is
    copied to the other replicas. A shard computes its whole share of the
    batch for each minibatch (the weights keep the shapes static, so no
    count is read back to the host). With one device it is a
    ``PPOTrainer``."""

    def __init__(self, envs, config: PPOConfig, raw_obs, seed: int = 0, total_updates: Optional[int] = None):
        self.config = config
        self.trainers = [PPOTrainer(env, config, raw, seed=seed + i, total_updates=total_updates)
                         for i, (env, raw) in enumerate(zip(envs, raw_obs))]
        lead = self.trainers[0]
        self.device, self.model, self.optimizer = lead.device, lead.model, lead.optimizer
        self.generator = lead.generator
        self._sync_replicas()

    def _sync_replicas(self):
        with torch.no_grad():
            for t in self.trainers[1:]:
                for p, q in zip(self.model.parameters(), t.model.parameters()):
                    q.copy_(p)

    def rollout(self, obs, elapsed):
        """Each shard's rollout: lists of (obs, elapsed, traj), one per
        shard."""
        out = [t.rollout(o, e) for t, o, e in zip(self.trainers, obs, elapsed)]
        return [o[0] for o in out], [o[1] for o in out], [o[2] for o in out]

    def update(self, obs, trajs) -> Dict[str, torch.Tensor]:
        """The minibatch epochs over every shard's trajectory (``obs`` and
        ``trajs``: lists, one per shard); the metrics as tensors on the
        first shard's device."""
        if len(self.trainers) == 1:
            return self.trainers[0].update(obs[0], trajs[0])
        cfg, dev, lead = self.config, self.device, self.trainers[0]
        batches, widths, advs_all = [], [], []
        for t, o, traj in zip(self.trainers, obs, trajs):
            t_obs, t_act, t_logp, t_rew, t_done, t_val, _ = traj
            with torch.no_grad():
                last_value = t.model(o)[2]
            advs, returns = compute_gae(t_rew, t_done, t_val, last_value, cfg.gamma, cfg.gae_lambda)
            flat = lambda x: x.reshape((-1,) + x.shape[2:])  # noqa: E731
            batches.append((_tree_map(flat, t_obs), flat(t_act), flat(t_logp), flat(advs), flat(returns)))
            widths.append(t_act.shape[1])
            advs_all.append(advs)
        steps, n_envs = trajs[0][1].shape[0], sum(widths)
        n = steps * n_envs
        mb_size = n // cfg.num_minibatches
        offsets = np.cumsum([0] + widths)
        params = [list(t.model.parameters()) for t in self.trainers]
        losses = []
        for _ in range(cfg.update_epochs):
            perm = torch.randperm(n, generator=self.generator, device=dev)
            for i in range(cfg.num_minibatches):
                member = torch.zeros(n, dtype=torch.float32, device=dev)
                member[perm[i * mb_size:(i + 1) * mb_size]] = 1.0
                member = member.view(steps, n_envs)
                weights = [member[:, offsets[s]:offsets[s + 1]].reshape(-1).to(t.device)
                           for s, t in enumerate(self.trainers)]
                with torch.no_grad():
                    adv_mean = sum((w * b[3]).sum().to(dev) for w, b in zip(weights, batches)) / mb_size
                    sq = [(w * (b[3] - adv_mean.to(t.device)) ** 2).sum().to(dev)
                          for w, b, t in zip(weights, batches, self.trainers)]
                    adv_std = torch.sqrt(sum(sq) / mb_size)
                total = torch.zeros((), device=dev)
                for s, (t, w, b) in enumerate(zip(self.trainers, weights, batches)):
                    t.optimizer.zero_grad(set_to_none=True)
                    loss = _ppo_shard_loss(t.model, b, w, adv_mean.to(t.device), adv_std.to(t.device), mb_size, cfg,
                                           with_entropy=s == 0)
                    loss.backward()
                    total = total + loss.detach().to(dev)
                with torch.no_grad():
                    for lead_p, *others in zip(*params):
                        for q in others:
                            lead_p.grad += q.grad.to(dev)
                clip_by_global_norm_(params[0], cfg.max_grad_norm)
                lead.optimizer.step()
                if lead.scheduler is not None:
                    lead.scheduler.step()
                self._sync_replicas()
                losses.append(total)
        # the shards' trajectories side by side on the env axis, on one device
        merged = tuple(_cat_envs(parts, dev) for parts in zip(*trajs))
        return _update_metrics(losses, merged, _cat_envs(advs_all, dev), params[0])

    def train_step(self, obs, elapsed):
        """One PPO iteration on every shard: rollouts, then the update.
        Returns (obs, elapsed, metrics), the first two lists per shard."""
        obs, elapsed, trajs = self.rollout(obs, elapsed)
        return obs, elapsed, self.update(obs, trajs)


def make_sharded_ppo_step(
    devices=None,
    num_envs: int = 8,
    env_id: str = "PushCube-v1",
    config: PPOConfig = PPOConfig(rollout_steps=2, update_epochs=1, num_minibatches=1),
    smoke: bool = False,
):
    """The data-parallel PPO train step over ``devices`` (a list of
    ``torch.device``; every visible CUDA device by default), the port's
    counterpart of the mesh-sharded step: one state env of ``num_envs /
    len(devices)`` envs on each device, reset with the seeds an unsharded
    reset of ``num_envs`` envs would take. One step runs before it returns.
    Returns ``(run_once, env)``: ``run_once()`` takes one train step and
    returns its metrics (``run_once.trainer`` is the ``ShardedPPOTrainer``);
    ``env`` is the env, or with several devices the list of the shards'
    envs."""
    import maniskill_tpu_torch.envs  # noqa: F401  (registers the tasks)

    from ..utils.registration import make

    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("no CUDA device is visible; pass devices=[torch.device('cpu')] to run on the CPU")
    devices = [torch.device(d) for d in devices]
    assert num_envs % len(devices) == 0, f"num_envs={num_envs} does not split over {len(devices)} devices"
    per = num_envs // len(devices)
    envs = [make(env_id, num_envs=per, obs_mode="state", device=d) for d in devices]
    raw = [env.reset(seed=i * per)[0] for i, env in enumerate(envs)]
    trainer = ShardedPPOTrainer(envs, config, raw)
    obs = [t.obs_tf(r) for t, r in zip(trainer.trainers, raw)]
    elapsed = [torch.zeros(per, dtype=torch.int32, device=d) for d in devices]

    def run_once():
        nonlocal obs, elapsed
        obs, elapsed, metrics = trainer.train_step(obs, elapsed)
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        return metrics

    run_once.trainer = trainer
    metrics = run_once()
    if smoke:
        print("dryrun_multichip ok:", {k: float(v) for k, v in metrics.items()}, "devices:", len(devices))
    return run_once, envs[0] if len(envs) == 1 else envs


EVAL_STEPS = 50  # one episode of the PPO tasks, as the reference CLIs evaluate


def evaluate(env, model: nn.Module, stochastic: bool = False, seed: int = 123):
    """Reset with ``seed`` and run the policy (its mean when not
    ``stochastic``) for EVAL_STEPS control steps with no auto-reset;
    returns the (num_envs,) bool tensor of envs that succeeded at least once."""
    base = env.unwrapped
    obs_tf = make_obs_transform(base)
    raw, _ = env.reset(seed=seed)
    success = torch.zeros(base.num_envs, dtype=torch.bool, device=base.device)
    g = torch.Generator(device=base.device)
    g.manual_seed(seed)
    with torch.no_grad():
        for _ in range(EVAL_STEPS):
            mean, log_std, _ = model(obs_tf(raw))
            act = mean + torch.exp(log_std) * torch.randn(mean.shape, generator=g, device=base.device) \
                if stochastic else mean
            raw, _, _, _, info = env.step(act)
            success = success | info["success"]
    return success


# ----------------------------------------------------------------------------
# weights carried across from and to the JAX package's flax trees
# ----------------------------------------------------------------------------
# flax auto-names ActorCritic's layers in construction order, and
# ``nn.Dense(1)(mlp(x))`` builds the value head before its trunk
_STATE_NAMES = {
    "Dense_0": "actor.0", "Dense_1": "actor.2", "Dense_2": "actor_mean",
    "Dense_3": "value_head", "Dense_4": "critic.0", "Dense_5": "critic.2",
}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# kernel axes between the packages: dense (in, out) <-> (out, in), conv HWIO
# <-> OIHW; stacked dense kernels (n, in, out) keep flax's layout
_TO_TORCH_AXES = {2: (1, 0), 4: (3, 2, 0, 1)}
_TO_FLAX_AXES = {2: (1, 0), 4: (2, 3, 1, 0)}


def params_from_flax(tree, names: Optional[Dict[str, str]] = None) -> "OrderedDict[str, torch.Tensor]":
    """A flax parameter tree ({"params": {...}} of numpy arrays) -> the state
    dict of the port's module: dense kernels (in, out) -> weights (out, in),
    conv kernels HWIO -> OIHW, stacked kernels (n, in, out) as they are,
    LayerNorm scales -> weights. ``names`` maps a flax module path ("/"
    joined) to the port's module name (default: PPO's ActorCritic; other
    paths keep their names, "/" -> ".")."""
    names = _STATE_NAMES if names is None else names
    out = OrderedDict()
    for path, value in _flat(tree["params"]):
        value = np.array(value, np.float32)
        *mods, leaf = path
        name = names.get("/".join(mods), ".".join(mods))
        if leaf == "kernel" and value.ndim in _TO_TORCH_AXES:
            value = value.transpose(_TO_TORCH_AXES[value.ndim])
        leaf = "weight" if leaf in ("kernel", "scale") else leaf
        out[f"{name}.{leaf}" if name else leaf] = torch.from_numpy(np.ascontiguousarray(value))
    return out


def params_to_flax(state_dict, names: Optional[Dict[str, str]] = None) -> dict:
    """The inverse of ``params_from_flax``: a port state dict -> a flax
    parameter tree of float32 numpy arrays."""
    names = _STATE_NAMES if names is None else names
    to_flax = {v: k for k, v in names.items()}
    params: dict = {}
    for key, value in state_dict.items():
        value = value.detach().cpu().numpy().astype(np.float32)
        *mods, leaf = key.split(".")
        name = ".".join(mods)
        mods = to_flax[name].split("/") if name in to_flax else mods
        if leaf == "weight" and mods[-1].startswith("LayerNorm"):
            leaf = "scale"
        elif leaf == "weight":
            value = value.transpose(_TO_FLAX_AXES[value.ndim]) if value.ndim in _TO_FLAX_AXES else value
            leaf = "kernel"
        node = params
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(value)
    return {"params": params}


def load_jax_checkpoint(path) -> dict:
    """A pickled flax parameter tree of numpy arrays, written by either
    package's PPO CLI (only unpickle files of a source you trust)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def save_checkpoint(model: nn.Module, path):
    """Pickle ``model``'s weights as the JAX package's CLIs do (a flax
    parameter tree of numpy arrays)."""
    with open(path, "wb") as f:
        pickle.dump(params_to_flax(model.state_dict()), f)
