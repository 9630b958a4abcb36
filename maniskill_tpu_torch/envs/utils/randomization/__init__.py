"""Per-env randomization: the batched RNG, placement sampling and camera
poses (counterpart of maniskill_tpu/envs/utils/randomization)."""
import math

import torch

from .batched_rng import BatchedRNG
from .camera import batched_look_at, make_camera_rectangular_prism, noised_look_at
from .samplers import UniformPlacementSampler

__all__ = ["BatchedRNG", "UniformPlacementSampler", "batched_look_at", "make_camera_rectangular_prism",
           "noised_look_at", "random_quaternions"]


def random_quaternions(rng, lock_x=False, lock_y=False, lock_z=False, bounds=None) -> torch.Tensor:
    """(B, 4) random unit quaternions from the env's ``BatchedRNG``: a yaw
    uniform in ``bounds`` (default [0, 2 pi)) when x and y are locked."""
    from ....utils.geometry import rotation_conversions as rc

    if lock_x and lock_y:
        lo, hi = bounds if bounds is not None else (0.0, 2 * math.pi)
        ang = rng.uniform(lo, hi)
        zeros = torch.zeros_like(ang)
        return rc.axis_angle_to_quaternion(torch.stack([zeros, zeros, ang], -1))
    return rng.quaternions(lock_x, lock_y, lock_z)
