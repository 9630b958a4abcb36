# Frozen copy of maniskill_tpu_torch/physics/drives.py at the benchmark's first version:
# the benchmark's plain reference. It imports nothing of the program and is
# never edited to follow it.
"""Body-body 6-dof drives (counterpart of maniskill_tpu/physics/drives.py).

A drive is a spring-damper wrench pulling a frame on body2 toward a frame
on body1 composed with a per-env target relative pose: the mechanism the
teleoperation CLIs use to drag objects. ``step`` computes the wrenches in
every substep from the substep's kinematics and adds them to
``xfrc_applied``.
"""
from __future__ import annotations

import torch

from . import rotation_conversions as rc
from .plan import model_plan
from .types import Data, Model


def drive_wrenches(model: Model, data: Data, kin) -> torch.Tensor:
    """(B, nbody, 6) [force at the COM, torque] per body to add to
    ``xfrc_applied``. ``kin`` is ``forward_kinematics_raw``'s (xpos, xquat,
    v, w), each (B, nb, 3|4); v is the velocity of each body's origin."""
    xpos, xquat, v, w = kin
    plan = model_plan(model)
    b1, b2 = plan.drive_b1, plan.drive_b2
    B, nb = xpos.shape[0], model.nbody

    p1b, q1b, v1b, w1b = xpos[:, b1], xquat[:, b1], v[:, b1], w[:, b1]  # (B, ND, .)
    p2b, q2b, v2b, w2b = xpos[:, b2], xquat[:, b2], v[:, b2], w[:, b2]

    # world drive frames, the target offset composed in frame 1
    l1p, l1q = model.drive6_pose1[:, :3], model.drive6_pose1[:, 3:]
    l2p, l2q = model.drive6_pose2[:, :3], model.drive6_pose2[:, 3:]
    tp, tq = data.drive6_target[..., :3], data.drive6_target[..., 3:]
    f1p = p1b + rc.quaternion_apply(q1b, l1p)
    f1q = rc.quaternion_multiply(q1b, l1q)
    f1p = f1p + rc.quaternion_apply(f1q, tp)
    f1q = rc.quaternion_multiply(f1q, tq)
    f2p = p2b + rc.quaternion_apply(q2b, l2p)
    f2q = rc.quaternion_multiply(q2b, l2q)

    # frame point velocities
    v1 = v1b + rc.cross(w1b, f1p - p1b)
    v2 = v2b + rc.cross(w2b, f2p - p2b)

    # explicit-integration stability: clamp each drive's gains to the
    # lightest dynamic body it joins (k <= 0.25 m / h^2, c <= 0.5 m / h);
    # angular gains clamp against the smallest principal inertia. Per-env
    # tables read env 0's row, as the reference does.
    h = model.timestep
    mass = model.body_mass
    if mass.ndim == 2:
        mass = mass[0]
    inert = torch.amin(model.body_inertia, dim=-1)
    if inert.ndim == 2:
        inert = inert[0]
    big = 1e9

    def m_eff(tab):
        m1 = torch.where(plan.dyn[b1] > 0, tab[b1], big)
        m2 = torch.where(plan.dyn[b2] > 0, tab[b2], big)
        return torch.minimum(m1, m2)  # (ND,)

    me, ie = m_eff(mass), m_eff(inert)
    ks, kd = model.drive6_stiffness, model.drive6_damping  # (ND, 2)
    ks_lin = torch.minimum(ks[:, 0], 0.25 * me / h**2)[None, :, None]
    ks_ang = torch.minimum(ks[:, 1], 0.25 * ie / h**2)[None, :, None]
    kd_lin = torch.minimum(kd[:, 0], 0.5 * me / h)[None, :, None]
    kd_ang = torch.minimum(kd[:, 1], 0.5 * ie / h)[None, :, None]
    lim = model.drive6_force_limit

    force = ks_lin * (f1p - f2p) + kd_lin * (v1 - v2)
    fmag = torch.linalg.vector_norm(force, dim=-1, keepdim=True)
    force = force * torch.clamp(lim[None, :, 0:1] / torch.clamp(fmag, min=1e-9), max=1.0)

    # orientation error as the rotation vector of q_err = f1q * f2q^-1
    # (quaternion_to_axis_angle is finite at the identity: a drive at rest)
    q_err = rc.quaternion_multiply(f1q, rc.quaternion_invert(f2q))
    torque = ks_ang * rc.quaternion_to_axis_angle(q_err) + kd_ang * (w1b - w2b)
    tmag = torch.linalg.vector_norm(torque, dim=-1, keepdim=True)
    torque = torque * torch.clamp(lim[None, :, 1:2] / torch.clamp(tmag, min=1e-9), max=1.0)

    # +F on body2 at f2, -F on body1 at f1. xfrc's force acts at the COM and
    # its torque is a pure couple, so the arms are measured from the COMs.
    com1 = p1b + rc.quaternion_apply(q1b, model.body_ipos[b1])
    com2 = p2b + rc.quaternion_apply(q2b, model.body_ipos[b2])
    t2 = torque + rc.cross(f2p - com2, force)
    t1 = -torque + rc.cross(f1p - com1, -force)
    # index_add_ sums repeated bodies (every world-anchored drive has body1 0)
    out = xpos.new_zeros(B, nb, 6)
    out.index_add_(1, b2, torch.cat([force, t2], -1))
    out.index_add_(1, b1, torch.cat([-force, t1], -1))
    return out
