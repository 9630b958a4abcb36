"""Camera-pose randomization helpers (counterpart of
maniskill_tpu/envs/utils/randomization/camera.py).

Eye positions sampled inside a rotated box, look-at targets and the roll
about the viewing axis perturbed with Gaussian noise: per-env camera-pose
domain randomization. Every draw comes from a ``torch.Generator`` or is
passed in as a tensor of standard draws.
"""
from __future__ import annotations

import math

import torch

from ....structs.pose import Pose
from ....utils.geometry.rotation_conversions import (
    axis_angle_to_quaternion,
    cross,
    matrix_to_quaternion,
    quaternion_multiply,
)


def _const3(like: torch.Tensor, v) -> torch.Tensor:
    """A constant 3-vector broadcast to ``like``, filled on its device (no
    host-to-device copy)."""
    out = torch.zeros_like(like)
    for i, x in enumerate(v):
        if x:
            out[..., i] = float(x)
    return out


def batched_look_at(eye: torch.Tensor, target: torch.Tensor, up=(0.0, 0.0, 1.0)) -> Pose:
    """Batched look-at in the ROS camera convention (+x toward the target,
    +z up): (N, 3) or (3,) eyes and targets -> (N, 7) poses."""
    eye, target = torch.broadcast_tensors(torch.atleast_2d(eye), torch.atleast_2d(target))
    fwd = target - eye
    fwd = fwd / torch.clamp(torch.linalg.vector_norm(fwd, dim=-1, keepdim=True), min=1e-9)
    left = cross(_const3(fwd, up), fwd)
    # degenerate (fwd parallel to up): y is the up hint instead
    deg = torch.linalg.vector_norm(left, dim=-1, keepdim=True) < 1e-6
    left = torch.where(deg, cross(_const3(fwd, (0.0, 1.0, 0.0)), fwd), left)
    left = left / torch.clamp(torch.linalg.vector_norm(left, dim=-1, keepdim=True), min=1e-9)
    rot = torch.stack([fwd, left, cross(fwd, left)], -1)  # columns x=fwd, y=left, z=up
    return Pose.create_from_pq(eye, matrix_to_quaternion(rot))


def make_camera_rectangular_prism(n: int, scale=(0.1, 0.1, 0.1), center=(0, 0, 0), theta: float = 0.0,
                                  generator: torch.Generator = None, uniform: torch.Tensor = None,
                                  device=None) -> torch.Tensor:
    """(n, 3) camera eyes uniform in a box of full extents ``scale``,
    rotated by ``theta`` about z and centred at ``center``; ``uniform`` is
    (n, 3) draws in [0, 1) (drawn from ``generator`` when absent)."""
    if uniform is None:
        uniform = torch.rand(n, 3, generator=generator, device=device)
    dev = uniform.device
    xyz = (uniform - 0.5) * torch.as_tensor(scale, dtype=torch.float32, device=dev)
    c, s = math.cos(theta), math.sin(theta)
    rot = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], dtype=torch.float32, device=dev)
    return xyz @ rot.T + torch.as_tensor(center, dtype=torch.float32, device=dev)


def noised_look_at(eye: torch.Tensor, target, look_at_noise: float = 1e-2, view_axis_rot_noise: float = 2e-1,
                   generator: torch.Generator = None, target_normal: torch.Tensor = None,
                   roll_normal: torch.Tensor = None) -> Pose:
    """Look-at poses with Gaussian noise on the target and on the roll about
    the viewing direction. ``target_normal`` (n, 3) and ``roll_normal`` (n,)
    are standard normal draws (drawn from ``generator`` when absent)."""
    eye = torch.atleast_2d(eye)
    n = eye.shape[0]
    target = torch.as_tensor(target, dtype=torch.float32, device=eye.device).expand(n, 3)
    if target_normal is None:
        target_normal = torch.randn(n, 3, generator=generator, device=eye.device)
    if roll_normal is None:
        roll_normal = torch.randn(n, generator=generator, device=eye.device)
    noised = target + target_normal * look_at_noise
    poses = batched_look_at(eye, noised)
    axes = noised - eye
    unit = axes / torch.clamp(torch.linalg.vector_norm(axes, dim=-1, keepdim=True), min=1e-9)
    roll = axis_angle_to_quaternion(unit * (roll_normal * view_axis_rot_noise)[:, None])
    return Pose.create_from_pq(poses.p, quaternion_multiply(roll, poses.q))
