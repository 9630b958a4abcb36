"""FrameStack (counterpart of maniskill_tpu/wrappers/frame_stack.py): the
last ``num_stack`` flat observations, stacked on axis 1."""
from __future__ import annotations

from collections import deque

import numpy as np
import torch

from ..utils import gym_utils
from .base import ObservationWrapper


class FrameStack(ObservationWrapper):
    def __init__(self, env, num_stack: int):
        super().__init__(env)
        self.num_stack = num_stack
        self.frames = deque(maxlen=num_stack)
        base = env.unwrapped
        single = base.single_observation_space
        assert isinstance(single, gym_utils.Box), "FrameStack expects flat Box obs"
        low = np.repeat(single.low[None], num_stack, axis=0)
        high = np.repeat(single.high[None], num_stack, axis=0)
        self.single_observation_space = gym_utils.Box(low, high, dtype=single.dtype)
        self.observation_space = gym_utils.batch_space(self.single_observation_space, base.num_envs)

    def observation(self, observation):
        return torch.stack(list(self.frames), 1)

    def reset(self, *, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        for _ in range(self.num_stack):
            self.frames.append(obs)
        return self.observation(obs), info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self.frames.append(obs)
        return self.observation(obs), reward, terminated, truncated, info
