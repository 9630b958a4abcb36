"""A gymnasium-free wrapper base (the port's stand-in for ``gymnasium.Wrapper``,
``ObservationWrapper`` and ``ActionWrapper``, which the JAX package's
wrappers derive from; the card's machine has no gymnasium).

A wrapper forwards every attribute it does not set to the env it wraps, so
spaces, ``num_envs``, ``device`` and ``max_episode_steps`` read through any
stack; ``unwrapped`` is the innermost env.
"""
from __future__ import annotations


class Wrapper:
    def __init__(self, env):
        self.env = env

    @property
    def unwrapped(self):
        return self.env.unwrapped

    def __getattr__(self, name):
        if name.startswith("__") or name == "env":
            raise AttributeError(name)
        return getattr(self.env, name)

    def reset(self, *, seed=None, options=None):
        return self.env.reset(seed=seed, options=options)

    def step(self, action):
        return self.env.step(action)

    def render(self):
        return self.env.render()

    def close(self):
        return self.env.close()

    def __repr__(self):
        return f"<{type(self).__name__}{self.env!r}>"


class ObservationWrapper(Wrapper):
    """Maps every observation through ``observation``."""

    def reset(self, *, seed=None, options=None):
        obs, info = self.env.reset(seed=seed, options=options)
        return self.observation(obs), info

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return self.observation(obs), reward, terminated, truncated, info

    def observation(self, observation):
        raise NotImplementedError


class ActionWrapper(Wrapper):
    """Maps every action through ``action`` before the env steps."""

    def step(self, action):
        return self.env.step(self.action(action))

    def action(self, action):
        raise NotImplementedError
