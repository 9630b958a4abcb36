"""Per-env batched RNG (counterpart of
maniskill_tpu/envs/utils/randomization/batched_rng.py).

Each env owns a ``torch.Generator`` seeded from its episode seed, so episode
content depends only on that env's seed, not on the batch size or the
device. Draws are made on the host generators and moved to ``device`` in one
copy per draw. The numbers differ from the JAX package's for the same seed.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch


class BatchedRNG:
    def __init__(self, generators: Sequence[torch.Generator], device="cpu"):
        self.generators = list(generators)
        self.device = torch.device(device)

    @classmethod
    def from_seeds(cls, seeds: Sequence[int], device="cpu") -> "BatchedRNG":
        gens = []
        for s in seeds:
            g = torch.Generator()
            g.manual_seed(int(s))
            gens.append(g)
        return cls(gens, device)

    @property
    def batch_size(self) -> int:
        return len(self.generators)

    def _draw(self, fn, size) -> torch.Tensor:
        size = (size,) if isinstance(size, int) else tuple(size)
        out = torch.stack([fn(size, generator=g) for g in self.generators])
        return out.to(self.device)

    def uniform(self, low=0.0, high=1.0, size=()) -> torch.Tensor:
        """(B, *size) uniform draws; ``size`` excludes the batch dim."""
        return low + (high - low) * self._draw(torch.rand, size)

    def normal(self, loc=0.0, scale=1.0, size=()) -> torch.Tensor:
        return loc + scale * self._draw(torch.randn, size)

    def quaternions(self, lock_x=False, lock_y=False, lock_z=False) -> torch.Tensor:
        """(B, 4) random unit wxyz quaternions; locking x and y gives a
        uniform yaw about z."""
        from ....utils.geometry import rotation_conversions as rc

        if lock_x and lock_y and not lock_z:
            ang = self.uniform(0.0, 2 * math.pi)
            zeros = torch.zeros_like(ang)
            return rc.axis_angle_to_quaternion(torch.stack([zeros, zeros, ang], -1))
        q = self.normal(size=(4,))
        return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
