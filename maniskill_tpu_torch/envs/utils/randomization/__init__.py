"""Per-env randomization: the batched RNG and placement sampling
(counterpart of maniskill_tpu/envs/utils/randomization)."""
from .batched_rng import BatchedRNG
from .samplers import UniformPlacementSampler

__all__ = ["BatchedRNG", "UniformPlacementSampler"]
