# Frozen copy of maniskill_tpu_torch/utils/geometry/rotation_conversions.py at the benchmark's first version:
# the benchmark's plain reference. It imports nothing of the program and is
# never edited to follow it.
"""Batched rotation helpers on torch tensors (counterpart of
maniskill_tpu/utils/geometry/rotation_conversions.py).

Quaternions use the **wxyz** convention (scalar first). Every function
broadcasts over leading batch dimensions. A random draw comes from a
``torch.Generator`` or is passed in as a tensor.
"""
from __future__ import annotations

import torch


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, broadcasting like ``jnp.cross``
    (``linalg.cross`` broadcasts operands of one rank itself)."""
    if a.ndim != b.ndim:
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


# the reference's name; for a unit quaternion the inverse is the conjugate
quaternion_invert = quaternion_conjugate


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


def _axis_quat(axis: str, angle: torch.Tensor) -> torch.Tensor:
    half = 0.5 * angle
    c, s, z = torch.cos(half), torch.sin(half), torch.zeros_like(angle)
    if axis == "X":
        return torch.stack([c, s, z, z], -1)
    if axis == "Y":
        return torch.stack([c, z, s, z], -1)
    return torch.stack([c, z, z, s], -1)


def euler_angles_to_quaternion(euler: torch.Tensor, convention: str = "XYZ") -> torch.Tensor:
    """Intrinsic Euler angles (..., 3) -> wxyz quaternion: for "XYZ",
    R = Rx(e0) Ry(e1) Rz(e2)."""
    q = _axis_quat(convention[0], euler[..., 0])
    for i, axis in enumerate(convention[1:], start=1):
        q = quaternion_multiply(q, _axis_quat(axis, euler[..., i]))
    return q


def euler2quat(ai, aj, ak, axes: str = "sxyz") -> torch.Tensor:
    """transforms3d's ``euler2quat`` for static "sxyz" (R = Rz(ak) Ry(aj)
    Rx(ai)) and rotating "rxyz" frames; float32 on the angles' device."""
    ang = [a if isinstance(a, torch.Tensor) else torch.tensor(a, dtype=torch.float32) for a in (ai, aj, ak)]
    ai, aj, ak = torch.broadcast_tensors(*(a.to(torch.float32) for a in ang))
    if axes == "sxyz":
        return euler_angles_to_quaternion(torch.stack([ak, aj, ai], -1), "ZYX")
    if axes == "rxyz":
        return euler_angles_to_quaternion(torch.stack([ai, aj, ak], -1), "XYZ")
    raise NotImplementedError(f"euler axes {axes}")


def random_quaternions(n: int, generator: torch.Generator = None, dtype=torch.float32, device=None,
                       normal: torch.Tensor = None) -> torch.Tensor:
    """(n, 4) uniform random unit wxyz quaternions with a non-negative real
    part, from (n, 4) standard normal draws: ``normal`` when given, else
    drawn from ``generator``."""
    if normal is None:
        normal = torch.randn(n, 4, generator=generator, dtype=dtype, device=device)
    q = normal / torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
    return standardize_quaternion(q)


def quaternion_slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical linear interpolation between unit quaternions (the shorter
    arc); ``t`` broadcasts against (..., 1)."""
    d = torch.sum(q0 * q1, -1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    theta = torch.arccos(torch.clamp(torch.abs(d), -1.0, 1.0))
    sin_t = torch.sin(theta)
    small = sin_t < 1e-6
    safe = torch.where(small, torch.ones_like(sin_t), sin_t)
    w0 = torch.where(small, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w1 = torch.where(small, t * torch.ones_like(sin_t), torch.sin(t * theta) / safe)
    out = w0 * q0 + w1 * q1
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Zhou et al.'s continuous 6D rotation (the first two rows) -> matrix."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.linalg.vector_norm(a1, dim=-1, keepdim=True)
    b2 = a2 - torch.sum(b1 * a2, -1, keepdim=True) * b1
    b2 = b2 / torch.linalg.vector_norm(b2, dim=-1, keepdim=True)
    return torch.stack([b1, b2, cross(b1, b2)], -2)


def matrix_to_rotation_6d(m: torch.Tensor) -> torch.Tensor:
    return m[..., :2, :].reshape(m.shape[:-2] + (6,))
