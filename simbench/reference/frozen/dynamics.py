# Frozen copy of maniskill_tpu_torch/physics/dynamics.py at the benchmark's first version:
# the benchmark's plain reference. It imports nothing of the program and is
# never edited to follow it.
"""Smooth (contact-free) dynamics: mass matrix, bias forces, PD actuation
(counterpart of maniskill_tpu/physics/dynamics.py).

Composite-rigid-body through COM Jacobians:

    M(q)      = Σ_b J_lin^T m_b J_lin + J_rot^T I_b J_rot
    c(q, qd)  = Σ_b J_lin·m_b(a_com_bias - g) + J_rot·(I α_bias + ω×(I ω))

PD joint drives are explicit torque with *implicit* damping: the kd (and dof
damping) terms are added to the LHS diagonal, (M + h·diag(kd + damping))
qacc = τ, which keeps stiff gains stable at the default timestep.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import rotation_conversions as rc
from .kinematics import _gb, dof_frames_from, forward_kinematics_raw
from .plan import model_plan
from .types import Data, Model

def _quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (..., 3, 3) in the reference CRB pass's own arithmetic
    (cf.quat_to_mat_c)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
    ], -2)


def _symv(S6: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Symmetric 3x3 matvec from packed [xx,yy,zz,xy,xz,yz] components."""
    xx, yy, zz, xy, xz, yz = S6.unbind(-1)
    vx, vy, vz = v.unbind(-1)
    return torch.stack([
        xx * vx + xy * vy + xz * vz,
        xy * vx + yy * vy + yz * vz,
        xz * vx + yz * vy + zz * vz,
    ], -1)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def mass_matrix_and_bias_kin(model: Model, data: Data, kin) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (M (B,nv,nv), qfrc_bias (B,nv)) from the FK tuple ``kin``.

    Composite-rigid-body via subtree *moments*: accumulate per-body moments
    [m, m c, m|c|^2, m c c^T, I_w, f, c x f + tau] over each dof's subtree
    with ONE contraction against the static ancestor mask, then assemble
    M[d,e] = A_d . X_e + H_d . Y_e from per-dof 3-vectors (derivation in the
    reference's mass_matrix_and_bias_cf). M qacc = tau - qfrc_bias.
    """
    xpos, xquat, v, w = kin
    plan = model_plan(model)
    dyn = plan.dyn  # (nb,)
    m = model.body_mass * dyn  # (nb,) or (B, nb)

    com = xpos + rc.quaternion_apply(xquat, model.body_ipos)  # (B, nb, 3)

    # world inertia symmetric components (B, nb, 6), masked by dyn
    R = _quat_to_mat(rc.quaternion_multiply(xquat, model.body_iquat.expand(xquat.shape)))
    d = model.body_inertia  # (nb, 3) or (B, nb, 3)

    def iw(i, j):
        return (R[..., i, 0] * d[..., 0] * R[..., j, 0]
                + R[..., i, 1] * d[..., 1] * R[..., j, 1]
                + R[..., i, 2] * d[..., 2] * R[..., j, 2]) * dyn

    J2 = torch.stack([iw(0, 0), iw(1, 1), iw(2, 2), iw(0, 1), iw(0, 2), iw(1, 2)], -1)

    # velocity-product (bias) accelerations, level-scheduled
    a0 = torch.zeros_like(xpos)
    al0 = torch.zeros_like(xpos)
    for lv in plan.levels:
        bl, pl = lv["bodies"], lv["parents"]
        r = xpos[:, bl] - xpos[:, pl]
        om_p = w[:, pl]
        a_b = a0[:, pl] + rc.cross(al0[:, pl], r) + rc.cross(om_p, v[:, bl] - v[:, pl])
        al_b = al0[:, pl]
        qd = (data.qvel[:, lv["v_idx"]] * lv["has_q"])[..., None]
        axis_w = rc.quaternion_apply(xquat[:, bl], _gb(model.jnt_axis, bl).expand(r.shape))
        cor = rc.cross(om_p, axis_w * qd)
        al0[:, bl] = torch.where(lv["is_hinge"], al_b + cor, al_b)
        a0[:, bl] = torch.where(lv["is_slide"], a_b + cor, a_b)

    rc_ = com - xpos
    a_com = a0 + rc.cross(al0, rc_) + rc.cross(w, rc.cross(w, rc_))

    # per-body gravity compensation mask; externally applied wrenches (world
    # frame, force at COM) fold into the bias pass
    g = model.gravity * (1.0 - model.body_gravcomp)[..., None]  # (nb|B,nb, 3)
    xf = data.xfrc_applied
    f = m[..., None] * (a_com - g) - xf[..., :3] * dyn[:, None]
    tau_b = _symv(J2, al0) + rc.cross(w, _symv(J2, w)) - xf[..., 3:] * dyn[:, None]
    T = rc.cross(com, f) + tau_b

    B = xpos.shape[0]
    mc = m[..., None] * com
    S2 = torch.stack([
        mc[..., 0] * com[..., 0], mc[..., 1] * com[..., 1], mc[..., 2] * com[..., 2],
        mc[..., 0] * com[..., 1], mc[..., 0] * com[..., 2], mc[..., 1] * com[..., 2],
    ], -1)
    payload = torch.cat(
        [m.expand(B, model.nbody)[..., None], mc, _dot(mc, com)[..., None], S2, J2, f, T], -1
    )  # (B, nb, 23)
    comp = torch.einsum("nv,bnk->bvk", plan.ancestor, payload)  # (B, nv, 23)
    mC = comp[..., 0:1]
    mc_c = comp[..., 1:4]
    trS = comp[..., 4:5]
    S2_c = comp[..., 5:11]
    J2_c = comp[..., 11:17]
    Fc = comp[..., 17:20]
    Tc = comp[..., 20:23]

    a_d, anchor_d = dof_frames_from(model, xpos, xquat)
    h = rc.cross(a_d, anchor_d)
    ir = plan.dof_is_rot.to(xpos.dtype)[None, :, None]  # (1, nv, 1)

    u2 = rc.cross(a_d, mc_c)
    X = ir * (trS * a_d - _symv(S2_c, a_d) - rc.cross(mc_c, h) + _symv(J2_c, a_d)) + (1.0 - ir) * (-u2)
    Y = ir * (-u2 + mC * h) + (1.0 - ir) * (-mC * a_d)
    L6 = torch.cat([a_d * ir, h * ir - a_d * (1.0 - ir)], -1)  # (B, nv, 6)
    R6 = torch.cat([X, Y], -1)
    M_low = torch.einsum("bdk,bek->bde", L6, R6)
    M = M_low * plan.crb_lower + (M_low * plan.crb_strict).transpose(1, 2)

    irf = ir[..., 0]
    qfrc_bias = irf * (_dot(a_d, Tc) - _dot(h, Fc)) + (1.0 - irf) * _dot(a_d, Fc)
    return M, qfrc_bias


def mass_matrix_and_bias(model: Model, data: Data) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recompute kinematics from data.qpos/qvel, then the CRB pass."""
    kin = forward_kinematics_raw(model, data.qpos, data.qvel)
    return mass_matrix_and_bias_kin(model, data, kin)


def joint_positions(model: Model, data: Data) -> torch.Tensor:
    """(B, nv) vector of per-dof positions (free-joint dofs read as 0)."""
    if model.nv == 0:
        return data.qpos.new_zeros(data.batch_size, 0)
    plan = model_plan(model)
    return data.qpos[:, plan.q_of_dof] * plan.q_mask


def actuation(model: Model, data: Data) -> torch.Tensor:
    """PD drive torque (explicit part), clipped to force limits."""
    q = joint_positions(model, data)
    tau = model.drive_kp * (data.drive_target - q) + model.drive_kd * (
        data.drive_vel_target - data.qvel
    )
    return torch.clamp(tau, -model.drive_force_limit, model.drive_force_limit)


def smooth_dynamics(model: Model, data: Data, kin=None):
    """Inverse LHS and unconstrained velocity prediction.

    Returns (Minv (B,nv,nv) inverse of M_imp, qvel_pred (B,nv), qacc).
    ``kin`` is the FK tuple from ``forward_kinematics_raw`` (recomputed from
    data when omitted).
    """
    h = model.timestep
    if kin is None:
        kin = forward_kinematics_raw(model, data.qpos, data.qvel)
    M, qfrc_bias = mass_matrix_and_bias_kin(model, data, kin)
    tau = actuation(model, data) + data.qf_applied

    # passive joint springs: explicit force + implicit h^2*k on the diagonal
    q = joint_positions(model, data)
    tau = tau - model.dof_stiffness * (q - model.dof_springref)

    # implicit terms on the diagonal: armature + h*(kd + damping + h*k)
    diag = model.dof_armature + h * (
        model.drive_kd + model.dof_damping + h * model.dof_stiffness
    )
    # kinematic FREE bodies own dofs the dynamics must not integrate; they
    # carry zero rows in M, so pin their diagonal to keep M_imp SPD
    kin_mask = model_plan(model).kinematic_dof_mask
    diag = diag + kin_mask
    M_imp = M + torch.diag_embed(diag.expand(data.batch_size, model.nv))
    tau = tau - model.dof_damping * data.qvel  # explicit dof damping

    Minv = spd_inverse(M_imp)
    qacc = torch.einsum("bij,bj->bi", Minv, tau - qfrc_bias) * (1.0 - kin_mask)
    return Minv, data.qvel + h * qacc, qacc


def spd_inverse(M: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of small batched SPD matrices.

    Jacobi equilibration first: mass matrices mix scales (arm links ~5 kg m^2
    vs finger dofs ~1e-5), so f32 Cholesky cancellation noise can exceed the
    small pivots; the scaled system's condition is only the coupling
    condition. ``cholesky_ex`` keeps the device from synchronizing on an error
    check (a non-SPD batch entry shows up as NaN downstream), and the inverse
    is formed as L^-T L^-1 with a triangular solve, because
    ``torch.cholesky_inverse`` synchronizes the stream on CUDA.
    """
    s = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(M, dim1=-2, dim2=-1), min=1e-12))
    L, _ = torch.linalg.cholesky_ex(M * s[..., :, None] * s[..., None, :])
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device).expand(L.shape)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return (Linv.mT @ Linv) * s[..., :, None] * s[..., None, :]
