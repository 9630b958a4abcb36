"""Stable-Baselines3 VecEnv adapter (counterpart of
maniskill_tpu/vector/sb3.py, after mani_skill/vector/wrappers/sb3.py):
numpy in and out, per-env info dicts. Duck-typed: it imports nothing of
stable-baselines3.

A step's results (obs, rewards, terminations, truncations and the info
values) leave the device through one byte buffer and one device-to-host
copy."""
from __future__ import annotations

from typing import List

import numpy as np
import torch


def _to_host(items: list) -> list:
    """``items`` (tensors, nested dicts of tensors, or other values) as
    numpy, every tensor among them copied through one byte buffer."""
    tensors = []

    def collect(x):
        if isinstance(x, dict):
            for v in x.values():
                collect(v)
        elif isinstance(x, torch.Tensor):
            tensors.append(x)

    for x in items:
        collect(x)
    host = []
    if tensors:
        dev = tensors[0].device
        buf = torch.cat([t.to(dev).contiguous().reshape(-1).view(torch.uint8) for t in tensors]).cpu().numpy()
        off = 0
        for t in tensors:
            dtype = torch.empty((), dtype=t.dtype).numpy().dtype
            n = t.numel() * dtype.itemsize
            host.append(buf[off:off + n].view(dtype).reshape(tuple(t.shape)))
            off += n
    host = iter(host)

    def convert(x):
        if isinstance(x, dict):
            return {k: convert(v) for k, v in x.items()}
        return next(host) if isinstance(x, torch.Tensor) else np.asarray(x)

    return [convert(x) for x in items]


class ManiSkillSB3VectorEnv:
    """Duck-typed sb3 VecEnv over a batched ManiSkill env."""

    def __init__(self, env):
        self._env = env
        base = env.unwrapped
        self.num_envs = base.num_envs
        self.observation_space = base.single_observation_space
        self.action_space = base.single_action_space
        self._actions = None

    def reset(self):
        obs, _ = self._env.reset()
        return _to_host([obs])[0]

    def step_async(self, actions: np.ndarray):
        self._actions = actions

    def step_wait(self):
        obs, rew, term, trunc, info = self._env.step(self._actions)
        keys = [k for k, v in info.items() if not isinstance(v, dict)]
        obs, rew, term, trunc, *values = _to_host([obs, rew, term, trunc] + [info[k] for k in keys])
        dones = term | trunc
        infos: List[dict] = []
        flat = dict(zip(keys, values))
        for i in range(self.num_envs):
            d = {k: v[i] for k, v in flat.items() if np.ndim(v) > 0}
            d["TimeLimit.truncated"] = bool(trunc[i]) and not bool(term[i])
            infos.append(d)
        return obs, rew, dones, infos

    def step(self, actions):
        self.step_async(actions)
        return self.step_wait()

    def close(self):
        self._env.close()

    def get_attr(self, name, indices=None):
        return [getattr(self._env.unwrapped, name)] * self.num_envs

    def env_is_wrapped(self, wrapper_class, indices=None):
        return [False] * self.num_envs
