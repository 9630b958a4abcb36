"""CPUGymWrapper (counterpart of maniskill_tpu/wrappers/gymnasium.py):
unbatches a num_envs == 1 env to a single-env interface of numpy arrays and
Python scalars."""
from __future__ import annotations

import numpy as np
import torch

from .base import Wrapper


def _unbatch(x):
    """Drop the leading env axis of every leaf, as numpy."""
    if isinstance(x, dict):
        return {k: _unbatch(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    return x[0] if x.ndim > 0 and x.shape[0] == 1 else x


class CPUGymWrapper(Wrapper):
    def __init__(self, env, ignore_terminations: bool = False, record_metrics: bool = False):
        super().__init__(env)
        base = env.unwrapped
        assert base.num_envs == 1, "CPUGymWrapper requires num_envs=1"
        self.ignore_terminations = ignore_terminations
        self.record_metrics = record_metrics
        self.observation_space = base.single_observation_space
        self.action_space = base.single_action_space
        self._return = 0.0
        self._length = 0
        self._success_once = False
        self._fail_once = False

    def reset(self, *, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        self._return, self._length = 0.0, 0
        self._success_once = self._fail_once = False
        return _unbatch(obs), self._unbatch_info(info)

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        reward = float(_unbatch(reward).reshape(-1)[0])
        terminated = bool(_unbatch(terminated).reshape(-1)[0])
        truncated = bool(_unbatch(truncated).reshape(-1)[0])
        info = self._unbatch_info(info)
        if self.record_metrics:
            self._return += reward
            self._length += 1
            if info.get("success"):
                self._success_once = True
            if info.get("fail"):
                self._fail_once = True
            episode = dict(r=self._return, l=self._length)
            if "success" in info:
                episode["success_once"] = self._success_once
                episode["success_at_end"] = bool(info["success"])
            if "fail" in info:
                episode["fail_once"] = self._fail_once
                episode["fail_at_end"] = bool(info["fail"])
            info["episode"] = episode
        if self.ignore_terminations:
            terminated = False
        return _unbatch(obs), reward, terminated, truncated, info

    def _unbatch_info(self, info):
        out = {}
        for k, v in info.items():
            if isinstance(v, dict):
                out[k] = self._unbatch_info(v)
            else:
                arr = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                out[k] = arr.reshape(-1)[0] if arr.size == 1 else arr
        return out

    def render(self):
        out = self.env.render()
        return None if out is None else _unbatch(out)
