"""Space helpers (counterpart of maniskill_tpu/utils/gym_utils.py).

The port does not depend on gymnasium, so it carries the two spaces its envs
and controllers describe themselves with: ``Box`` and ``Dict``.
"""
from __future__ import annotations

from typing import Any, Dict as TDict, Optional

import numpy as np
import torch


class Box:
    """A box in R^n with per-dimension bounds (gymnasium ``Box`` layout)."""

    def __init__(self, low, high, shape=None, dtype=np.float32):
        self.dtype = np.dtype(dtype)
        if shape is None:
            shape = np.broadcast_shapes(np.shape(low), np.shape(high))
        self.shape = tuple(shape)
        self.low = np.broadcast_to(np.asarray(low, self.dtype), self.shape).copy()
        self.high = np.broadcast_to(np.asarray(high, self.dtype), self.shape).copy()

    def sample(self, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """A uniform draw from the box (a standard normal draw along an
        unbounded dimension), as gymnasium's ``Box.sample`` draws."""
        rng = rng if rng is not None else np.random.default_rng()
        bounded = np.isfinite(self.low) & np.isfinite(self.high)
        out = np.where(bounded, rng.uniform(np.where(bounded, self.low, 0.0), np.where(bounded, self.high, 1.0)),
                       rng.standard_normal(self.shape))
        return out.astype(self.dtype)

    def __repr__(self):
        if not self.low.size:
            return f"Box({self.shape}, {self.dtype})"
        return f"Box({self.low.min()}, {self.high.max()}, {self.shape}, {self.dtype})"


class Dict:
    """A dict of named sub-spaces."""

    def __init__(self, spaces: TDict[str, Any]):
        self.spaces = dict(spaces)

    def __getitem__(self, key):
        return self.spaces[key]

    def __repr__(self):
        return f"Dict({self.spaces})"


def convert_observation_to_space(obs: Any, unbatched: bool = True):
    """Derive a space from an example (batched) observation."""
    if isinstance(obs, dict):
        return Dict({k: convert_observation_to_space(v, unbatched) for k, v in obs.items()})
    if isinstance(obs, torch.Tensor):
        shape, dtype = tuple(obs.shape), torch.empty((), dtype=obs.dtype).numpy().dtype
    else:
        arr = np.asarray(obs)
        shape, dtype = arr.shape, arr.dtype
    shape = shape[1:] if unbatched else shape
    if dtype == np.bool_:
        return Box(0, 1, shape, np.bool_)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return Box(info.min, info.max, shape, dtype)
    return Box(-np.inf, np.inf, shape, np.float32)


def find_max_episode_steps_value(env):
    """The first ``max_episode_steps`` down the wrapper chain (the port's
    ``TimeLimitWrapper`` carries it), or None."""
    cur = env
    while cur is not None:
        if getattr(cur, "max_episode_steps", None) is not None:
            return cur.max_episode_steps
        cur = getattr(cur, "env", None)
    return None


def batch_space(space, n: int):
    """The space of ``n`` stacked samples of ``space``."""
    if isinstance(space, Dict):
        return Dict({k: batch_space(v, n) for k, v in space.spaces.items()})
    return Box(
        np.broadcast_to(space.low, (n,) + space.shape),
        np.broadcast_to(space.high, (n,) + space.shape),
        (n,) + space.shape,
        space.dtype,
    )
