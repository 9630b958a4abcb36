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
    def create_from_pq(cls, p=None, q=None) -> "Pose":
        """A pose from a position (zero if None) and a wxyz quaternion (the
        identity if None), each broadcast to the other's batch shape: a
        tensor pose on the device of a tensor argument, else a host pose."""
        ref = next((x for x in (p, q) if isinstance(x, torch.Tensor)), None)
        if ref is None:
            p = np.zeros(3, np.float32) if p is None else np.asarray(p, np.float32)
            q = np.array([1, 0, 0, 0], np.float32) if q is None else np.asarray(q, np.float32)
            batch = np.broadcast_shapes(p.shape[:-1], q.shape[:-1])
            return cls(np.concatenate([np.broadcast_to(p, batch + (3,)), np.broadcast_to(q, batch + (4,))], -1))
        p = torch.zeros(3, device=ref.device) if p is None else _as_tensor_like(p, ref)
        q = torch.tensor([1.0, 0.0, 0.0, 0.0], device=ref.device) if q is None else _as_tensor_like(q, ref)
        batch = torch.broadcast_shapes(p.shape[:-1], q.shape[:-1])
        return cls(torch.cat([p.expand(batch + (3,)), q.expand(batch + (4,))], -1))

    @classmethod
    def identity(cls, batch_shape=(), dtype=torch.float32, device=None) -> "Pose":
        """Identity poses of ``batch_shape`` (a ``dtype`` tensor on ``device``)."""
        raw = torch.zeros(tuple(batch_shape) + (7,), dtype=dtype, device=device)
        raw[..., 3] = 1.0
        return cls(raw)

    @classmethod
    def from_matrix(cls, m: torch.Tensor) -> "Pose":
        """Poses of (..., 4, 4) homogeneous transforms."""
        return cls(torch.cat([m[..., :3, 3], rc.matrix_to_quaternion(m[..., :3, :3])], -1))

    @property
    def p(self):
        return self.raw_pose[..., :3]

    @property
    def q(self):
        return self.raw_pose[..., 3:]

    @property
    def shape(self):
        return tuple(self.raw_pose.shape[:-1])

    def replace(self, p=None, q=None) -> "Pose":
        """A new pose with ``p`` and/or ``q`` replaced, each broadcast to the
        batch (a tensor pose where any of them is a tensor)."""
        raw = self.raw_pose
        if _is_tensor(raw, p, q):
            ref = next(x for x in (raw, p, q) if isinstance(x, torch.Tensor))
            raw = _as_tensor_like(raw, ref).clone()
            if p is not None:
                raw[..., :3] = _as_tensor_like(p, ref)
            if q is not None:
                raw[..., 3:] = _as_tensor_like(q, ref)
            return Pose(raw)
        raw = np.array(raw, copy=True)
        if p is not None:
            raw[..., :3] = np.asarray(p, raw.dtype)
        if q is not None:
            raw[..., 3:] = np.asarray(q, raw.dtype)
        return Pose(raw)

    set_p = replace

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

    def transform_point(self, point):
        """``point`` (..., 3) mapped by the pose: p + q * point."""
        raw = self.raw_pose
        if _is_tensor(raw, point):
            ref = raw if isinstance(raw, torch.Tensor) else point
            raw, point = _as_tensor_like(raw, ref), _as_tensor_like(point, ref)
        return raw[..., :3] + _quat_apply(raw[..., 3:], point)

    def to_transformation_matrix(self):
        """(..., 4, 4) homogeneous transforms (numpy for a host pose)."""
        raw = self.raw_pose
        if isinstance(raw, torch.Tensor):
            m = torch.zeros(self.shape + (4, 4), dtype=raw.dtype, device=raw.device)
            m[..., :3, :3] = rc.quaternion_to_matrix(raw[..., 3:])
            m[..., :3, 3] = raw[..., :3]
            m[..., 3, 3] = 1.0
            return m
        w, x, y, z = (raw[..., 3 + i] for i in range(4))
        rot = np.stack([
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ], axis=-1).reshape(self.shape + (3, 3))
        m = np.zeros(self.shape + (4, 4), dtype=raw.dtype)
        m[..., :3, :3] = rot
        m[..., :3, 3] = raw[..., :3]
        m[..., 3, 3] = 1.0
        return m

    def __repr__(self):
        return f"Pose(shape={self.shape})"


def vectorize_pose(pose) -> Union[torch.Tensor, np.ndarray]:
    """The (..., 7) raw pose of a Pose or of an array-like."""
    return Pose.create(pose).raw_pose

