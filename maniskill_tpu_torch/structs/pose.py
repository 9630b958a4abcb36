"""Batched rigid-transform ``Pose`` (counterpart of maniskill_tpu/structs/pose.py).

Storage is one array ``raw_pose`` of shape (..., 7) = [p(3), q_wxyz(4)]. Host
data (builders, camera configs) stays numpy; as soon as a torch tensor is
involved the result is a tensor on that tensor's device.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..utils.geometry import rotation_conversions as rc


def _is_tensor(*arrays) -> bool:
    return any(isinstance(a, torch.Tensor) for a in arrays)


def _cross(a, b):
    return rc.cross(a, b) if isinstance(a, torch.Tensor) else np.cross(a, b)


def _quat_mul(a, b):
    if isinstance(a, torch.Tensor):
        return rc.quaternion_multiply(a, b)
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def _quat_apply(q, v):
    w = q[..., :1]
    u = q[..., 1:]
    uxv = _cross(u, v)
    return v + 2.0 * (w * uxv + _cross(u, uxv))


def _as_tensor_like(x, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x,
                           dtype=torch.float32, device=ref.device)


class Pose:
    __slots__ = ("raw_pose",)

    def __init__(self, raw_pose):
        if isinstance(raw_pose, (torch.Tensor, np.ndarray)):
            self.raw_pose = raw_pose
        else:
            self.raw_pose = np.asarray(raw_pose, np.float32)

    @classmethod
    def create(cls, pose: Union["Pose", torch.Tensor, np.ndarray]) -> "Pose":
        if isinstance(pose, Pose):
            return pose
        if isinstance(pose, torch.Tensor):
            return cls(pose)
        return cls(np.asarray(pose, np.float32))

    @classmethod
    def create_from_pq(cls, p: torch.Tensor, q: torch.Tensor) -> "Pose":
        """A pose from a position and a wxyz quaternion, each broadcast to the
        other's batch shape (both tensors on one device)."""
        batch = torch.broadcast_shapes(p.shape[:-1], q.shape[:-1])
        return cls(torch.cat([p.expand(batch + (3,)), q.expand(batch + (4,))], -1))

    @property
    def p(self):
        return self.raw_pose[..., :3]

    @property
    def q(self):
        return self.raw_pose[..., 3:]

    @property
    def shape(self):
        return tuple(self.raw_pose.shape[:-1])

    def __mul__(self, other) -> "Pose":
        """Pose composition: (self * other)(x) == self(other(x))."""
        other = Pose.create(other)
        a, b = self.raw_pose, other.raw_pose
        if _is_tensor(a, b):
            ref = a if isinstance(a, torch.Tensor) else b
            a, b = _as_tensor_like(a, ref), _as_tensor_like(b, ref)
            p = a[..., :3] + _quat_apply(a[..., 3:], b[..., :3])
            q = _quat_mul(a[..., 3:], b[..., 3:])
            batch = torch.broadcast_shapes(p.shape[:-1], q.shape[:-1])
            return Pose(torch.cat([p.expand(batch + (3,)), q.expand(batch + (4,))], -1))
        p = a[..., :3] + _quat_apply(a[..., 3:], b[..., :3])
        q = _quat_mul(a[..., 3:], b[..., 3:])
        batch = np.broadcast_shapes(p.shape[:-1], q.shape[:-1])
        return Pose(np.concatenate(
            [np.broadcast_to(p, batch + (3,)), np.broadcast_to(q, batch + (4,))], -1))

    def inv(self) -> "Pose":
        raw = self.raw_pose
        if isinstance(raw, torch.Tensor):
            q_inv = torch.cat([raw[..., 3:4], -raw[..., 4:]], -1)
            return Pose(torch.cat([-_quat_apply(q_inv, raw[..., :3]), q_inv], -1))
        q_inv = raw[..., 3:] * np.array([1.0, -1.0, -1.0, -1.0], raw.dtype)
        return Pose(np.concatenate([-_quat_apply(q_inv, raw[..., :3]), q_inv], -1))

    def __repr__(self):
        return f"Pose(shape={self.shape})"

