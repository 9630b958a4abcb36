"""CachedResetWrapper (counterpart of maniskill_tpu/wrappers/cached_reset.py):
precomputes a pool of reset states and restores random samples from it
through ``reset_to_env_states``, for fast resets that keep the initial-state
diversity.

The pool lives on the env's device. The draws of pool rows come from
``self.generator`` (a ``torch.Generator`` on the device, seeded with
``seed``), or are given as ``options["cached_idx"]`` (a (num_envs,) index
tensor), which is how a test feeds it the JAX package's draws.
"""
from __future__ import annotations

from typing import Optional

import torch

from .base import Wrapper


def _tree_cat(chunks, n: int):
    if isinstance(chunks[0], dict):
        return {k: _tree_cat([c[k] for c in chunks], n) for k in chunks[0]}
    return torch.cat(chunks, 0)[:n]


def _tree_index(tree, idx):
    if isinstance(tree, dict):
        return {k: _tree_index(v, idx) for k, v in tree.items()}
    return tree[idx]


class CachedResetWrapper(Wrapper):
    def __init__(self, env, num_resets: Optional[int] = None, seed: int = 0):
        super().__init__(env)
        base = env.unwrapped
        self.num_envs = base.num_envs
        self.num_resets = num_resets or base.num_envs
        self._seed = seed
        self._pool = None
        self.generator = torch.Generator(device=base.device)
        self.generator.manual_seed(seed)
        self._build_cache()

    def _build_cache(self):
        """A pool of ``num_resets`` initial states: as many full resets as
        needed (seeds ``seed``, ``seed + 1``, ...), their state dicts
        concatenated along the env axis."""
        base = self.env.unwrapped
        chunks, n_have, i = [], 0, 0
        while n_have < self.num_resets:
            self.env.reset(seed=self._seed + i)
            chunks.append(base.get_state_dict())
            n_have += self.num_envs
            i += 1
        self._pool = _tree_cat(chunks, self.num_resets)

    def sample_indices(self) -> torch.Tensor:
        base = self.env.unwrapped
        return torch.randint(0, self.num_resets, (self.num_envs,), generator=self.generator, device=base.device)

    def reset(self, *, seed=None, options=None):
        options = dict(options or {})
        if seed is not None or options.get("reconfigure", False):
            obs, info = self.env.reset(seed=seed, options=options)
            self._seed = seed if seed is not None else self._seed
            self._build_cache()
            return obs, info
        idx = options.pop("cached_idx", None)
        idx = self.sample_indices() if idx is None else torch.as_tensor(idx, device=self.env.unwrapped.device)
        options["reset_to_env_states"] = _tree_index(self._pool, idx)
        return self.env.reset(options=options)
