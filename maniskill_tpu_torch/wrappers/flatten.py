"""Flatten wrappers (counterpart of maniskill_tpu/wrappers/flatten.py)."""
from __future__ import annotations

import numpy as np
import torch

from ..utils import common, gym_utils
from .base import ActionWrapper, ObservationWrapper


class FlattenObservationWrapper(ObservationWrapper):
    """Flatten nested dict obs into one (B, D) vector."""

    def __init__(self, env):
        super().__init__(env)
        flat = common.flatten_state_dict(env.unwrapped._init_raw_obs)
        self.single_observation_space = gym_utils.Box(-np.inf, np.inf, flat.shape[1:], np.float32)
        self.observation_space = gym_utils.batch_space(self.single_observation_space, env.unwrapped.num_envs)

    def observation(self, observation):
        return common.flatten_state_dict(observation)


class FlattenRGBDObservationWrapper(ObservationWrapper):
    """Flatten obs into {state: (B, D), rgb: (B, H, W, 3k), depth: ...}: the
    cameras' images concatenated on the channel axis, with depth apart
    (``sep_depth``) or appended to rgb as ``rgbd``."""

    def __init__(self, env, rgb=True, depth=True, state=True, sep_depth=True):
        super().__init__(env)
        self.include_rgb = rgb
        self.include_depth = depth
        self.include_state = state
        self.sep_depth = sep_depth
        sample = self.observation(env.unwrapped._init_raw_obs)
        self.single_observation_space = gym_utils.convert_observation_to_space(sample)
        self.observation_space = gym_utils.batch_space(self.single_observation_space, env.unwrapped.num_envs)

    def observation(self, observation):
        obs = dict(observation)
        sensor_data = obs.pop("sensor_data", {})
        obs.pop("sensor_param", None)
        out = {}
        rgbs, depths = [], []
        for data in sensor_data.values():
            if self.include_rgb and "rgb" in data:
                rgbs.append(data["rgb"])
            if self.include_depth and "depth" in data:
                depths.append(data["depth"])
        if rgbs:
            out["rgb"] = torch.cat(rgbs, -1)
        if depths:
            if self.sep_depth:
                out["depth"] = torch.cat(depths, -1)
            elif rgbs:
                # the JAX package's jnp.concatenate promotes uint8 rgb and
                # int16 depth to int16
                out["rgbd"] = torch.cat([out.pop("rgb").to(depths[0].dtype)] + depths, -1)
        if self.include_state:
            out["state"] = common.flatten_state_dict(obs)
        return out


class FlattenActionSpaceWrapper(ActionWrapper):
    """Flatten a Dict action space (a ``MultiAgent``'s) into one Box; the
    flat action is split back into the dict, in the space's key order."""

    def __init__(self, env):
        super().__init__(env)
        base = env.unwrapped
        space = base.single_action_space
        if isinstance(space, gym_utils.Dict):
            lows, highs = [], []
            self._mapping = {}
            start = 0
            for k, sub in space.spaces.items():
                n = sub.shape[0]
                lows.append(sub.low)
                highs.append(sub.high)
                self._mapping[k] = (start, start + n)
                start += n
            self.single_action_space = gym_utils.Box(np.concatenate(lows), np.concatenate(highs), dtype=np.float32)
        else:
            self._mapping = None
            self.single_action_space = space
        self.action_space = gym_utils.batch_space(self.single_action_space, base.num_envs)

    def action(self, action):
        if self._mapping is None:
            return action
        return {k: action[..., lo:hi] for k, (lo, hi) in self._mapping.items()}
