"""Batched rotation helpers on torch tensors (counterpart of
maniskill_tpu/utils/geometry/rotation_conversions.py).

Quaternions use the **wxyz** convention (scalar first). Every function
broadcasts over leading batch dimensions. Only the functions the ported
modules call are here.
"""
from __future__ import annotations

import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, broadcasting like ``jnp.cross``."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of two wxyz quaternions (broadcasting)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quaternion_conjugate(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of wxyz quaternion(s), the inverse of a unit quaternion."""
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def quaternion_apply(q: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Rotate point(s) by quaternion(s): p' = p + 2w(u x p) + 2 u x (u x p)."""
    w = q[..., :1]
    u = q[..., 1:]
    uxp = cross(u, point)
    return point + 2.0 * (w * uxp + cross(u, uxp))


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz -> (..., 3, 3) rotation matrix."""
    w, x, y, z = q.unbind(-1)
    tx, ty, tz = 2.0 * x, 2.0 * y, 2.0 * z
    twx, twy, twz = tx * w, ty * w, tz * w
    txx, txy, txz = tx * x, ty * x, tz * x
    tyy, tyz, tzz = ty * y, tz * y, tz * z
    m = torch.stack(
        [
            1.0 - (tyy + tzz), txy - twz, txz + twy,
            txy + twz, 1.0 - (txx + tzz), tyz - twx,
            txz - twy, tyz + twx, 1.0 - (txx + tyy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 4) wxyz quaternion: Shepperd's
    method without branches (all four candidates, the one with the largest
    score kept), normalized, real part made non-negative."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], -1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], -1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], -1)
    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], -1)
    idx = torch.argmax(scores, -1)
    cands = torch.stack([qw, qx, qy, qz], -2)  # (..., candidate, 4)
    q = torch.gather(cands, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return standardize_quaternion(q)


def axis_angle_to_quaternion(axis_angle: torch.Tensor) -> torch.Tensor:
    """(..., 3) rotation vector -> (..., 4) wxyz quaternion (safe at 0)."""
    angle = torch.linalg.vector_norm(axis_angle, dim=-1, keepdim=True)
    half = 0.5 * angle
    small = angle < 1e-6
    sinc = torch.where(
        small,
        0.5 - angle * angle / 48.0,
        torch.sin(half) / torch.where(small, torch.ones_like(angle), angle),
    )
    return torch.cat([torch.cos(half), axis_angle * sinc], dim=-1)


def quat_diff_rad(q0: torch.Tensor, q1: torch.Tensor) -> torch.Tensor:
    """Angle (rad) between two unit quaternions."""
    d = torch.abs(torch.sum(q0 * q1, -1))
    return 2.0 * torch.arccos(torch.clamp(d, -1.0, 1.0))


def integrate_quaternion(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
    """q' = exp(0.5 * dt * omega) * q for a world-frame angular velocity."""
    dq = axis_angle_to_quaternion(omega * dt)
    out = quaternion_multiply(dq, q)
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)


def standardize_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) in the canonical form with a non-negative real part."""
    return torch.where(q[..., :1] < 0, -q, q)


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz -> (..., 3) rotation vector. The small-angle branch
    guards its division with a second ``where``, so ``norm == 0`` gives no
    NaN (in the value or in its gradient)."""
    q = standardize_quaternion(q)
    norm = torch.linalg.vector_norm(q[..., 1:], dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(norm, q[..., :1])
    small = norm < 1e-6
    scale = torch.where(
        small,
        2.0 + angle * angle / 12.0,
        angle / torch.where(small, torch.ones_like(norm), norm),
    )
    return q[..., 1:] * scale


def matrix_to_euler_angles(m: torch.Tensor, convention: str = "XYZ") -> torch.Tensor:
    """Rotation matrix -> intrinsic XYZ Euler angles, R = Rx(a) Ry(b) Rz(c)."""
    if convention != "XYZ":
        raise NotImplementedError(convention)
    b = torch.asin(torch.clamp(m[..., 0, 2], -1.0, 1.0))
    a = torch.atan2(-m[..., 1, 2], m[..., 2, 2])
    c = torch.atan2(-m[..., 0, 1], m[..., 0, 0])
    return torch.stack([a, b, c], -1)
