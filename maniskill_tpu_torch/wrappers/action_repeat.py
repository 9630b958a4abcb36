"""ActionRepeatWrapper (counterpart of
maniskill_tpu/wrappers/action_repeat.py): repeats each action ``repeat``
times, summing the rewards of the envs still running, and stops early once
every env is done (one host read of ``done`` per repeat, as the reference's
``bool(jnp.all(done))``)."""
from __future__ import annotations

import torch

from .base import Wrapper


class ActionRepeatWrapper(Wrapper):
    def __init__(self, env, repeat: int):
        super().__init__(env)
        self.repeat = repeat

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        total_reward = reward
        done = terminated | truncated
        for _ in range(self.repeat - 1):
            if bool(done.all()):
                break
            obs_i, r_i, term_i, trunc_i, info_i = self.env.step(action)
            total_reward = total_reward + torch.where(done, 0.0, r_i)
            # only the envs still running take the new obs (a dict obs is
            # taken whole, as the reference does)
            if isinstance(obs, dict):
                obs = obs_i
            else:
                obs = torch.where((~done).reshape((-1,) + (1,) * (obs.ndim - 1)), obs_i, obs)
            terminated = terminated | term_i
            truncated = truncated | trunc_i
            info = info_i
            done = terminated | truncated
        return obs, total_reward, terminated, truncated, info
