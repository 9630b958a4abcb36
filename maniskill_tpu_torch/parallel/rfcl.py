"""Reverse-Forward Curriculum Learning (counterpart of
maniskill_tpu/parallel/rfcl.py, after Tao et al., RFCL).

With a handful of demonstrations, SAC starts episodes from demo states near
the END of each demo and moves each demo's start back toward its first
state as that demo's success rate rises (the reverse curriculum). Once
every demo's start has reached t = 0, the forward phase resets through the
standard episodic path, with a share ``forward_demo_fraction`` of resets
still starting from demo states.

Demo states are a nested dict of (num_demos, T_max, ...) tensors on the
env's device. ``RFCLTrainer`` is ``SACTrainer`` (the networks, the replay
ring, RLPD's 50/50 demo mix, the reference's update order) with its own
collect: each env is tied to demo ``env % num_demos``; an env that ends its
episode resets, masked, through ``_reset_impl`` to its demo's state
max(T_d - 1 - k_d, 0) when it draws a demo start, else through the standard
masked reset, and the per-demo episode and success tallies feed the
per-demo success EMA that decides when k_d grows by ``reverse_step_size``.
The pointers, EMAs and tallies stay on the device: a train step reads
nothing back.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..utils import h5
from .sac import SACConfig, SACTrainer, sample_action


class RFCLConfig(NamedTuple):
    sac: SACConfig = SACConfig(ignore_terminations=False)
    reverse_step_size: int = 4  # states to step back per advance
    success_threshold: float = 0.75  # EMA needed to advance a demo's start
    ema: float = 0.34  # ~ the last 3 attempts (the reference's per_demo_buffer_size=3)
    forward_demo_fraction: float = 0.25  # demo-start resets in the forward phase


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _load_group(g):
    return {k: _load_group(v) if isinstance(v, h5.Group) else np.asarray(v[()]) for k, v in g.items()}


def _as_device_array(x: np.ndarray, device) -> torch.Tensor:
    """A numpy array as ``jnp.asarray`` stores it: 64-bit floats and ints
    narrowed to 32 bits."""
    x = np.asarray(x)
    if x.dtype == np.float64:
        x = x.astype(np.float32)
    elif x.dtype == np.int64:
        x = x.astype(np.int32)
    return torch.as_tensor(x, device=device)


def load_demo_states(h5path: str, num_demos: Optional[int] = None, device="cuda"):
    """Read ``env_states`` from a RecordEpisode .h5 into a nested dict of
    (D, T_max, ...) tensors, each demo padded to T_max by its last state,
    plus per-demo lengths (D,) int32 (T + 1 states). Also returns the flat
    demo transitions dict(obs, act, rew, next_obs, term) for the replay mix
    when the file holds flat state observations, else None."""
    state_trees, lens = [], []
    trans = {"obs": [], "act": [], "rew": [], "next_obs": [], "term": []}
    with h5.File(h5path, "r") as f:
        names = sorted([k for k in f.keys() if k.startswith("traj_")], key=lambda s: int(s.split("_")[1]))
        if num_demos is not None:
            names = names[:num_demos]
        for name in names:
            ep = f[name]
            state_trees.append(_load_group(ep["env_states"]))  # leaves (T+1, ...)
            T = len(np.asarray(ep["actions"][()]))
            lens.append(T + 1)
            obs = np.asarray(ep["obs"][()]) if "obs" in ep and isinstance(ep["obs"], h5.Dataset) else None
            if obs is not None and obs.ndim == 2:
                trans["obs"].append(obs[:-1])
                trans["next_obs"].append(obs[1:])
                trans["act"].append(np.asarray(ep["actions"][()]))
                trans["rew"].append(np.asarray(ep["rewards"][()]) if "rewards" in ep else np.zeros(T))
                trans["term"].append(np.asarray(ep["terminated"][()]) if "terminated" in ep else np.zeros(T, bool))

    T_max = max(lens)

    def pad_stack(*leaves):
        return _as_device_array(np.stack([
            np.pad(leaf, [(0, T_max - L)] + [(0, 0)] * (leaf.ndim - 1), mode="edge")
            for leaf, L in zip(leaves, lens)]), device)

    demo_states = _tree_map(pad_stack, *state_trees)
    demo_lens = torch.as_tensor(np.asarray(lens, np.int32), device=device)
    demos = None
    if trans["obs"]:
        demos = {k: _as_device_array(np.concatenate(v), device) for k, v in trans.items()}
    return demo_states, demo_lens, demos


def gather_start_states(demo_states, demo_lens: torch.Tensor, env_demo: torch.Tensor, k: torch.Tensor):
    """Each env's start state: index max(T_d - 1 - k_d, 0) of its demo d."""
    idx = torch.clamp(demo_lens[env_demo] - 1 - k[env_demo], min=0).long()
    return _tree_map(lambda x: x[env_demo, idx], demo_states)


def advance_curriculum(k: torch.Tensor, succ_ema: torch.Tensor, ep_cnt: torch.Tensor, ep_succ: torch.Tensor,
                       demo_lens: torch.Tensor, cfg: RFCLConfig):
    """The per-demo success EMA over the collect's tallies (demos with no
    finished episode keep theirs); a demo whose EMA passes the threshold
    steps its start back by ``reverse_step_size`` (at most to its first
    state) and restarts its EMA at 0. Returns (k, succ_ema)."""
    rate = ep_succ / torch.clamp(ep_cnt, min=1)
    ema = torch.where(ep_cnt > 0, (1 - cfg.ema) * succ_ema + cfg.ema * rate, succ_ema)
    advance = ema > cfg.success_threshold
    k = torch.where(advance, torch.minimum(k + cfg.reverse_step_size, demo_lens - 1), k)
    return k, torch.where(advance, torch.zeros_like(ema), ema)


class RFCLTrainer(SACTrainer):
    """SAC with the reverse-forward curriculum over ``demo_states``
    (``load_demo_states``'s tree and lengths, on the env's device).
    ``k`` (D,) int32 starts at 1 (one state from each demo's end),
    ``succ_ema`` (D,) at 0."""

    def __init__(self, env, demo_states, demo_lens: torch.Tensor, config: RFCLConfig, obs_dim: int,
                 seed: int = 0, demos: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__(env, config.sac, obs_dim, seed=seed, demos=demos)
        self.rfcl = config
        self.base = env.unwrapped
        dev = self.device
        self.demo_states = _tree_map(lambda x: x.to(dev), demo_states)
        self.demo_lens = demo_lens.to(dev)
        D = self.demo_lens.shape[0]
        self.env_demo = torch.arange(self.num_envs, device=dev) % D  # fixed assignment
        self.k = torch.ones(D, dtype=torch.int32, device=dev)
        self.succ_ema = torch.zeros(D, device=dev)
        self.episodes = torch.zeros((), dtype=torch.int32, device=dev)

    def reverse_done(self, k: torch.Tensor) -> torch.Tensor:
        return torch.all(k >= self.demo_lens - 1)

    def draw_collect(self) -> Dict[str, torch.Tensor]:
        """A collect's draws per control step: the actions' normal draws
        ``eps`` (R, B, A), the demo-start uniforms ``u`` (R, B) and the
        standard reset's ``seeds`` (R, B)."""
        R, B, g, dev = self.config.rollout_steps, self.num_envs, self.generator, self.device
        return dict(eps=torch.randn((R, B, self.act_dim), generator=g, device=dev),
                    u=torch.rand((R, B), generator=g, device=dev),
                    seeds=torch.randint(0, 2**31, (R, B), generator=g, device=dev))

    def collect(self, obs: torch.Tensor, elapsed: torch.Tensor, draws: Optional[Dict[str, torch.Tensor]] = None):
        """``rollout_steps`` control steps into the ring with the curriculum
        resets. Returns (obs, elapsed, per-demo episode count, per-demo
        success count)."""
        cfg = self.config
        draws = self.draw_collect() if draws is None else draws
        start_states = gather_start_states(self.demo_states, self.demo_lens, self.env_demo, self.k)
        reverse_phase = ~self.reverse_done(self.k)
        D = self.demo_lens.shape[0]
        ep_cnt = torch.zeros(D, device=self.device)
        ep_succ = torch.zeros(D, device=self.device)
        with torch.no_grad():
            for t in range(cfg.rollout_steps):
                action, _ = sample_action(self.actor, obs, draws["eps"][t])
                next_obs, reward, terminated = self.step_fn(action)
                elapsed = elapsed + 1
                done = terminated | ((elapsed >= self.max_steps) & ~terminated)
                # tasks terminate on success: per-demo episode and success tallies
                ep_cnt.index_add_(0, self.env_demo, done.to(torch.float32))
                ep_succ.index_add_(0, self.env_demo, (done & terminated).to(torch.float32))
                row = self.ptr + t
                self.buf_obs[row] = obs
                self.buf_act[row] = action
                self.buf_rew[row] = reward
                self.buf_next_obs[row] = next_obs
                self.buf_term[row] = terminated
                # a resetting env starts EITHER from its curriculum demo state
                # or through the standard episodic reset; both run masked
                use_demo = reverse_phase | (draws["u"][t] < self.rfcl.forward_demo_fraction)
                self.base._reset_impl(done & use_demo, draws["seeds"][t], start_states)
                obs = self.reset_fn(done & ~use_demo, draws["seeds"][t])
                elapsed = torch.where(done, 0, elapsed)
        self.ptr = (self.ptr + cfg.rollout_steps) % cfg.buffer_steps
        self.filled = min(self.filled + cfg.rollout_steps, cfg.buffer_steps)
        return obs, elapsed, ep_cnt, ep_succ

    def train_step(self, obs: torch.Tensor, elapsed: torch.Tensor, learn: bool, draws: Optional[dict] = None):
        """One collect, the curriculum's bookkeeping and, when ``learn``,
        ``utd`` SAC updates. ``draws``: optional dict(collect=draw_collect()'s
        dict, updates=[draw_update()'s dict per update]). Returns (obs,
        elapsed, metrics as device tensors)."""
        draws = draws or {}
        obs, elapsed, ep_cnt, ep_succ = self.collect(obs, elapsed, draws.get("collect"))
        self.k, self.succ_ema = advance_curriculum(self.k, self.succ_ema, ep_cnt, ep_succ, self.demo_lens,
                                                   self.rfcl)
        if learn:
            losses = [self.update_once(d) for d in draws.get("updates", [None] * self.config.utd)]
            q_loss, actor_loss = (torch.stack(x).mean() for x in zip(*losses))
        else:
            q_loss = actor_loss = torch.zeros((), device=self.device)
        self.episodes = self.episodes + ep_cnt.sum().to(torch.int32)
        return obs, elapsed, dict(q_loss=q_loss, actor_loss=actor_loss, alpha=torch.exp(self.log_alpha.detach()),
                                  mean_k=self.k.to(torch.float32).mean(),
                                  reverse_done=self.reverse_done(self.k).to(torch.float32),
                                  mean_succ_ema=self.succ_ema.mean())
