"""ManiSkillVectorEnv (counterpart of maniskill_tpu/vector/gymnasium.py).

The env is already natively batched; this wrapper adds same-step auto-reset
through a masked partial reset, final_observation/final_info bookkeeping,
the infinite-horizon mode (ignore_terminations) and episode metrics. It does
not subclass gymnasium's VectorEnv (the port does not depend on gymnasium).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..utils import gym_utils


class ManiSkillVectorEnv:
    def __init__(
        self,
        env,
        num_envs: Optional[int] = None,
        auto_reset: bool = True,
        ignore_terminations: bool = False,
        record_metrics: bool = False,
        **kwargs,
    ):
        if isinstance(env, str):
            from ..utils.registration import make

            env = make(env, num_envs=num_envs or 1, **kwargs)
        self._env = env
        self.auto_reset = auto_reset
        self.ignore_terminations = ignore_terminations
        self.record_metrics = record_metrics

        base = env.unwrapped
        self.num_envs = base.num_envs
        self.device = base.device
        self.single_action_space = base.single_action_space
        self.action_space = base.action_space
        self.single_observation_space = base.single_observation_space
        self.observation_space = base.observation_space
        self.max_episode_steps = gym_utils.find_max_episode_steps_value(env)

        if record_metrics:
            dev = self.device
            self.returns = torch.zeros(self.num_envs, device=dev)
            self.lengths = torch.zeros(self.num_envs, dtype=torch.int32, device=dev)
            self.success_once = torch.zeros(self.num_envs, dtype=torch.bool, device=dev)
            self.fail_once = torch.zeros(self.num_envs, dtype=torch.bool, device=dev)

    @property
    def env(self):
        return self._env

    @property
    def unwrapped(self):
        return self._env.unwrapped

    @property
    def base_env(self):
        return self._env.unwrapped

    def reset(self, *, seed=None, options=None):
        """``options["env_idx"]``: indices or a (num_envs,) bool tensor."""
        options = options or {}
        obs, info = self._env.reset(seed=seed, options=options)
        if self.record_metrics:
            mask = self.base_env.env_idx_mask(options.get("env_idx"))
            self.returns = torch.where(mask, 0.0, self.returns)
            self.lengths = torch.where(mask, 0, self.lengths)
            self.success_once = self.success_once & ~mask
            self.fail_once = self.fail_once & ~mask
        return obs, info

    def step(self, actions):
        obs, reward, terminated, truncated, info = self._env.step(actions)

        if self.record_metrics:
            episode = {}
            self.returns = self.returns + reward
            self.lengths = self.lengths + 1
            episode["r"] = self.returns
            episode["l"] = self.lengths
            if "success" in info:
                self.success_once = self.success_once | info["success"]
                episode["success_once"] = self.success_once
                episode["success_at_end"] = info["success"]
            if "fail" in info:
                self.fail_once = self.fail_once | info["fail"]
                episode["fail_once"] = self.fail_once
                episode["fail_at_end"] = info["fail"]
            info["episode"] = episode

        if self.ignore_terminations:
            terminated = torch.zeros_like(terminated)

        dones = terminated | truncated
        # the one host sync of a step: whether any env needs a reset
        if self.auto_reset and bool(dones.any()):
            final_obs, final_info = obs, info
            obs, _ = self.reset(options=dict(env_idx=dones))
            info = dict(info)
            info["final_observation"] = final_obs
            info["final_info"] = final_info
            info["_final_info"] = dones
            info["_elapsed_steps"] = final_info.get("elapsed_steps")
        return obs, reward, terminated, truncated, info

    def render(self):
        return self._env.render()

    def close(self):
        self._env.close()
