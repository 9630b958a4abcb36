# Frozen copy of maniskill_tpu_torch/envs/utils/randomization/batched_rng.py at the benchmark's
# first version: the benchmark's plain reference. It imports nothing of the program and is
# never edited to follow it.
"""Per-env batched RNG (counterpart of
maniskill_tpu/envs/utils/randomization/batched_rng.py).

A counter-based generator held as tensors on the env's device: each env has
an int64 seed, each draw a counter (0 for the first draw of a new
``BatchedRNG``), and each element of a draw is a 32-bit integer hash of
(seed, counter, element index). So an episode depends only on its env's
seed, not on the batch size or the device, and a draw is a few elementwise
kernels with no host loop and no host-to-device copy.

The hash is Wellons' ``lowbias32`` chained over the three inputs. Every value
is kept in [0, 2**32) inside int64 tensors and every product is split into
16-bit pieces, so no int64 overflow is relied on (and, the values being
non-negative, torch's arithmetic ``>>`` acts as a logical shift). The numbers
differ from the JAX package's for the same seed.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32) and a 32-bit constant c, from
    16-bit pieces of x (each partial product stays below 2**48)."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32: a bijection of [0, 2**32) with good avalanche."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


class BatchedRNG:
    def __init__(self, seeds: torch.Tensor):
        """seeds: (B,) int64 per-env seeds on the env's device."""
        self.seeds = seeds
        lo, hi = seeds & _M32, (seeds >> 32) & _M32
        self._keys = _hash32(lo ^ _hash32(hi ^ 0x5BD1E995))
        self._counter = 0

    @classmethod
    def from_seeds(cls, seeds, device=None) -> "BatchedRNG":
        """``seeds``: a (B,) tensor (kept on its device, so a device tensor
        needs no host copy) or a host sequence of ints (one copy to
        ``device``)."""
        if isinstance(seeds, torch.Tensor):
            seeds = seeds.to(device=device if device is not None else seeds.device, dtype=torch.int64)
        else:
            seeds = torch.as_tensor(np.asarray(seeds, np.int64).reshape(-1), device=device)
        return cls(seeds)

    @property
    def batch_size(self) -> int:
        return self.seeds.shape[0]

    @property
    def device(self) -> torch.device:
        return self.seeds.device

    def _bits(self, size) -> torch.Tensor:
        """(B, *size) 32-bit hashes of (seed, counter, element index), as
        int64; each call advances the counter."""
        size = (size,) if isinstance(size, int) else tuple(size)
        n = math.prod(size)
        stream = _hash32(self._keys ^ _hash32(torch.full_like(self._keys, self._counter & _M32)))
        self._counter += 1
        idx = _hash32(torch.arange(n, dtype=torch.int64, device=self.device) ^ 0x68E31DA4)
        return _hash32(stream[:, None] ^ idx[None, :]).reshape((self.batch_size,) + size)

    @staticmethod
    def _unit(bits: torch.Tensor) -> torch.Tensor:
        """The top 24 bits as a float32 in [0, 1) (exact in float32)."""
        return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))

    def uniform(self, low=0.0, high=1.0, size=()) -> torch.Tensor:
        """(B, *size) uniform draws in [low, high); ``size`` excludes the
        batch dim."""
        return low + (high - low) * self._unit(self._bits(size))

    rand = uniform

    def normal(self, loc=0.0, scale=1.0, size=()) -> torch.Tensor:
        """(B, *size) normal draws (Box-Muller on two uniforms per element)."""
        size = (size,) if isinstance(size, int) else tuple(size)
        bits = self._bits((2,) + size)
        u1 = 1.0 - self._unit(bits[:, 0])  # (0, 1]: the log stays finite
        u2 = self._unit(bits[:, 1])
        z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
        return loc + scale * z

    randn = normal

    def randint(self, low, high=None, size=()) -> torch.Tensor:
        """(B, *size) int32 draws in [low, high) (modulo reduction; its bias
        is below (high - low) / 2**32)."""
        if high is None:
            low, high = 0, low
        bits = self._bits(size)
        return (low + torch.remainder(bits, high - low)).to(torch.int32)

    def choice(self, n: int, size=()) -> torch.Tensor:
        return self.randint(0, n, size)

    def quaternions(self, lock_x=False, lock_y=False, lock_z=False, bounds=(0.0, 2 * math.pi)) -> torch.Tensor:
        """(B, 4) random unit wxyz quaternions; locking x and y gives a
        uniform yaw about z in ``bounds`` (the reference's formulas)."""
        from . import rotation_conversions as rc

        if lock_x and lock_y and not lock_z:
            ang = self.uniform(*bounds)
            zeros = torch.zeros_like(ang)
            return rc.axis_angle_to_quaternion(torch.stack([zeros, zeros, ang], -1))
        q = self.normal(size=(4,))
        return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
