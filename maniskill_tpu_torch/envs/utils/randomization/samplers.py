"""Batched placement sampling (counterpart of
maniskill_tpu/envs/utils/randomization/samplers.py)."""
from __future__ import annotations

from typing import List, Tuple

import torch


class UniformPlacementSampler:
    """Places objects one after another in a box, each at least its radius
    (plus the earlier object's) away from every earlier one: of
    ``candidates`` uniform draws per env it keeps the first that fits, or
    the farthest one if none does. ``bounds`` is a (2, dim) tensor of
    [low, high] on the env's device; the batch is the generator's, and
    ``batch_size`` and ``sample``'s ``max_trials`` are taken for the JAX
    package's signatures (neither is read there either)."""

    def __init__(self, bounds: torch.Tensor, batch_size: int = None, candidates: int = 16):
        self.lo, self.hi = bounds[0], bounds[1]
        self.batch_size, self.candidates = batch_size, candidates
        self._placed: List[Tuple[torch.Tensor, float]] = []

    def sample(self, rng, radius: float, max_trials: int = None) -> torch.Tensor:
        """(B, dim) placements from ``rng`` (the env's ``BatchedRNG``)."""
        cands = rng.uniform(0.0, 1.0, (self.candidates, self.lo.shape[0])) * (self.hi - self.lo) + self.lo
        if not self._placed:
            pick = cands[:, 0]
        else:
            min_d = torch.full(cands.shape[:2], float("inf"), device=cands.device)
            for prev, prev_r in self._placed:
                d = torch.linalg.vector_norm(cands - prev[:, None, :], dim=-1)
                min_d = torch.minimum(min_d, d - prev_r)
            ok = min_d >= radius
            first = torch.argmax(ok.to(torch.int32), 1)
            idx = torch.where(ok.any(1), first, torch.argmax(min_d, 1))
            pick = torch.gather(cands, 1, idx[:, None, None].expand(-1, 1, cands.shape[2]))[:, 0]
        self._placed.append((pick, radius))
        return pick
