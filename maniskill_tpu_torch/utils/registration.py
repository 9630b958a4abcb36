"""Env registration (counterpart of maniskill_tpu/utils/registration.py).

``@register_env`` records tasks in the package registry; ``make`` builds one
and wraps it in a batched time limit. The port does not register with
gymnasium (the card's machine has none).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Type

from ..wrappers.base import Wrapper

REGISTERED_ENVS: Dict[str, "EnvSpec"] = {}


@dataclass
class EnvSpec:
    uid: str
    cls: Type
    max_episode_steps: Optional[int] = None
    default_kwargs: Optional[Dict[str, Any]] = None

    def make(self, **kwargs):
        merged = dict(self.default_kwargs or {})
        merged.update(kwargs)
        return self.cls(**merged)


def register(name: str, cls, max_episode_steps=None, default_kwargs=None) -> EnvSpec:
    """Record ``cls`` under ``name`` unless the name is taken; returns the
    name's spec either way."""
    if name in REGISTERED_ENVS:
        return REGISTERED_ENVS[name]
    spec = EnvSpec(name, cls, max_episode_steps, default_kwargs)
    REGISTERED_ENVS[name] = spec
    return spec


def register_env(uid: str, max_episode_steps=None, override=False, **default_kwargs):
    """Class decorator recording ``cls`` under ``uid``."""

    def _register(cls):
        if uid in REGISTERED_ENVS and not override:
            raise ValueError(f"env {uid} already registered")
        REGISTERED_ENVS.pop(uid, None)
        register(uid, cls, max_episode_steps, default_kwargs)
        cls.uid = uid
        cls.max_episode_steps = max_episode_steps
        return cls

    return _register


class TimeLimitWrapper(Wrapper):
    """Batched truncation from elapsed_steps; forwards everything else."""

    def __init__(self, env, max_episode_steps: int):
        super().__init__(env)
        self._max_episode_steps = max_episode_steps

    @property
    def max_episode_steps(self):
        return self._max_episode_steps

    def reset(self, *args, **kwargs):
        return self.env.reset(*args, **kwargs)

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        truncated = truncated | (self.env.unwrapped.elapsed_steps >= self._max_episode_steps)
        return obs, reward, terminated, truncated, info


def make(uid: str, **kwargs):
    """Create a registered env (with its time limit)."""
    if uid not in REGISTERED_ENVS:
        raise KeyError(f"env {uid} not registered; known: {sorted(REGISTERED_ENVS)}")
    spec = REGISTERED_ENVS[uid]
    env = spec.make(**kwargs)
    if spec.max_episode_steps is not None:
        env = TimeLimitWrapper(env, spec.max_episode_steps)
    return env
