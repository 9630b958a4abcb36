# Frozen copy of maniskill_tpu_torch/physics/solver.py at the benchmark's first version:
# the benchmark's plain reference. It imports nothing of the program and is
# never edited to follow it.
"""Velocity-level contact/limit impulse solver (counterpart of
maniskill_tpu/physics/solver.py).

A batched accelerated projected-gradient iteration on the Delassus operator
A = J M⁻¹ Jᵀ: every iteration is two batched (B, nv, R) matvecs, so nothing
is sequential per contact.

Constraint rows:
- per contact point: 1 normal row (λ ≥ 0, Baumgarte positional bias) + 2
  friction rows (|λ_t| ≤ μ λ_n, box-projected cone).
- per limited dof: 1 unilateral row pushing back inside the limit range.

Unlike the reference, the iteration matvecs stay f32 (the reference feeds
the TPU's matrix unit bf16 copies of J and W), and top-K compaction gathers
with a stable descending sort + ``torch.gather`` instead of a one-hot
contraction.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .common import top_k_stable
from . import rotation_conversions as rc
from .dynamics import joint_positions
from .kinematics import dof_frames, dof_frames_from
from .plan import model_plan
from .types import Contact, Data, Model


def _tangent_basis(n: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two unit tangents orthogonal to n (branch-free)."""
    a = torch.zeros_like(n)
    a[..., 0] = 1.0
    a = torch.where(torch.abs(n[..., 0:1]) < 0.9, a, a.roll(1, -1))
    t1 = rc.cross(n, a)
    t1 = t1 / torch.clamp(torch.linalg.vector_norm(t1, dim=-1, keepdim=True), min=1e-9)
    return t1, rc.cross(n, t1)


def contact_jacobians(model: Model, data: Data, contact: Contact) -> torch.Tensor:
    """Relative-velocity Jacobian per contact: (B, C, nv, 3), with
    v_rel = J^T qvel = v(body2 at p) - v(body1 at p). Dense reference form;
    the solver builds the factored (B, nv, R) layout directly."""
    B = data.batch_size
    C = contact.pos.shape[1]
    if C == 0:
        return data.qpos.new_zeros(B, 0, model.nv, 3)
    dof_axis, dof_anchor = dof_frames(model, data)
    rel = contact.pos[:, :, None, :] - dof_anchor[:, None, :, :]  # (B, C, nv, 3)
    axis = dof_axis[:, None].expand(rel.shape)
    is_rot = model_plan(model).dof_is_rot[None, None, :, None]
    col = torch.where(is_rot, rc.cross(axis, rel), axis)
    return col * model_plan(model).weights_for(contact)[None, :, :, None]


def limit_rows(model: Model, data: Data):
    """Unilateral joint-limit rows.

    Returns (sign (B, L), depth (B, L), lim_dofs (L,) numpy). Row d's jacobian
    is sign * e_{lim_dofs[d]}; the active side (lower/upper) is chosen by
    proximity. A positive impulse pushes the dof back into range.
    """
    plan = model_plan(model)
    lim_dofs = plan.lim_dofs
    B = data.batch_size
    if len(lim_dofs) == 0:
        z = data.qpos.new_zeros(B, 0)
        return z, z, lim_dofs
    idx = plan.lim_dofs_t
    q = joint_positions(model, data)[:, idx]
    lo = model.dof_limit[..., idx, 0]
    hi = model.dof_limit[..., idx, 1]
    dist_lo = q - lo
    dist_hi = hi - q
    use_lo = dist_lo < dist_hi
    sign = torch.where(use_lo, 1.0, -1.0)
    depth = -torch.where(use_lo, dist_lo, dist_hi)  # >0 when violated
    return sign.expand(B, -1), depth.expand(B, -1), lim_dofs


def solve(
    model: Model,
    data: Data,
    Minv: torch.Tensor,
    qvel_pred: torch.Tensor,
    contact: Contact,
    kin=None,
) -> Tuple[torch.Tensor, Contact]:
    """Returns (qvel_new (B, nv), contact with impulses filled)."""
    B = data.batch_size
    nv = model.nv
    h = model.timestep
    dev = qvel_pred.device
    C_full = contact.pos.shape[1]

    # active-contact compaction: solve only the K deepest candidates per env
    K = model.max_active_contacts
    compact = 0 < K < C_full
    w_full = model_plan(model).weights_for(contact)  # (C_full, nv)
    prev_ok = data.contact is not None and data.contact.impulse.shape[1] == C_full
    crest_full = (
        contact.restitution if contact.restitution is not None
        else torch.zeros_like(contact.friction)
    )
    if compact:
        # ties keep the lower candidate id, as the reference's top_k does
        cdepth, idx = top_k_stable(contact.depth, K)  # (B, K)

        def take(x):
            return torch.gather(x, 1, idx[..., None].expand(B, K, x.shape[-1]))

        cpos, cnormal = take(contact.pos), take(contact.normal)
        cmu = torch.gather(contact.friction, 1, idx)
        crest = torch.gather(crest_full, 1, idx)
        prev_imp = take(data.contact.impulse) if prev_ok else None
        w = w_full[idx]  # (B, K, nv)
        C = K
    else:
        cdepth, cpos, cnormal, cmu = contact.depth, contact.pos, contact.normal, contact.friction
        crest = crest_full
        w = w_full[None].expand(B, C_full, nv)
        prev_imp = data.contact.impulse if prev_ok else None
        C = C_full

    sl_sign, limit_depth, lim_dofs = limit_rows(model, data)
    L = len(lim_dofs)
    R = C * 3 + L
    if R == 0:
        return qvel_pred, contact

    # contact jacobian directly in (B, nv, R) layout. Row (c,i) has direction
    # e = basis_i(c) at point p_c. Rotational dof (axis a, anchor q):
    # J = a.(p x e) - e.(a x q); translational: a.e. So
    #   J = [a*ir | a*(1-ir) - h*ir] @ [[p x e],[e]],  h = a x q.
    if C > 0:
        t1, t2 = _tangent_basis(cnormal)
        U = torch.stack([cnormal, t1, t2], 2)  # (B, C, 3 rows, 3 xyz)
        P = cpos[:, :, None, :].expand(U.shape)
        Rf = torch.cat([rc.cross(P, U), U], -1).reshape(B, C * 3, 6)  # (B, 3C, 6)
        if kin is not None:
            dof_axis, dof_anchor = dof_frames_from(model, kin[0], kin[1])
        else:
            dof_axis, dof_anchor = dof_frames(model, data)
        hvec = rc.cross(dof_axis, dof_anchor)
        ir = model_plan(model).dof_is_rot.to(torch.float32)[None, :, None]
        Lf = torch.cat([dof_axis * ir, dof_axis * (1.0 - ir) - hvec * ir], -1)  # (B, nv, 6)
        Jc = torch.einsum("bvk,brk->bvr", Lf, Rf)  # (B, nv, 3C)
        Jc = Jc * torch.repeat_interleave(w.transpose(1, 2), 3, dim=2)
    else:
        Jc = qvel_pred.new_zeros(B, nv, 0)

    if L > 0:
        plan = model_plan(model)
        Jl = qvel_pred.new_zeros(B, nv, L)
        Jl[:, plan.lim_dofs_t, plan.lim_rows_t] = sl_sign
        Jt = torch.cat([Jc, Jl], 2)  # (B, nv, R)
    else:
        Jt = Jc

    active_c = cdepth > -model.contact_margin
    arow = torch.cat([torch.repeat_interleave(active_c, 3, dim=1), limit_depth > -0.01], 1)
    Jt = Jt * arow[:, None, :]

    W = torch.bmm(Minv, Jt)  # M^-1 J^T (B, nv, R)
    diag_A = torch.sum(Jt * W, 1)
    inv_diag = torch.where(diag_A > 1e-9, 1.0 / torch.clamp(diag_A, min=1e-9), 0.0)

    # velocity bias: penetrating rows push out at beta/h * depth (capped);
    # separated rows within the margin are speculative — they may approach
    # at up to gap/h but not penetrate
    bias_c = torch.where(
        cdepth >= 0.0,
        torch.clamp(
            model.baumgarte / h * torch.clamp(cdepth - model.contact_slop, min=0.0),
            0.0, model.max_correction_vel,
        ),
        cdepth / h,
    )
    bias_l = torch.where(
        limit_depth >= 0.0,
        torch.clamp(model.baumgarte / h * limit_depth, 0.0, model.max_correction_vel),
        limit_depth / h,
    )
    v0 = torch.einsum("bvr,bv->br", Jt, qvel_pred)
    mu = cmu

    # restitution: rows approaching faster than bounce_threshold rebound at
    # e * approach speed
    if C > 0:
        v_n0 = v0[:, : C * 3].reshape(B, C, 3)[..., 0]
        approach = torch.clamp(-v_n0, min=0.0)
        bounce = torch.where(approach > model.bounce_threshold, crest * approach, 0.0)
        bias_c = torch.where(bounce > 0.0, torch.maximum(bias_c, bounce), bias_c)
    target = torch.zeros(B, C, 3, device=dev)
    target[..., 0] = bias_c
    target = torch.cat([target.reshape(B, C * 3), bias_l], 1)  # (B, R)

    def project(lam):
        cap_hi = model.max_impulse
        lc = lam[:, : C * 3].reshape(B, C, 3)
        ln = torch.clamp(lc[..., 0], 0.0, cap_hi)
        cap = mu * ln
        lt1 = torch.minimum(torch.maximum(lc[..., 1], -cap), cap)
        lt2 = torch.minimum(torch.maximum(lc[..., 2], -cap), cap)
        lc = torch.stack([ln, lt1, lt2], -1).reshape(B, C * 3)
        return torch.cat([lc, torch.clamp(lam[:, C * 3 :], 0.0, cap_hi)], 1)

    def matvec(x):
        dv = torch.bmm(W, x[..., None])  # (B, nv, 1)
        return torch.bmm(Jt.transpose(1, 2), dv)[..., 0]

    # step size omega = 0.85 / rho(D^-1 A), rho by 4 power iterations (the
    # Rayleigh quotient lands within a few % for these clustered spectra)
    x = arow.to(torch.float32)
    x = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)
    for _ in range(4):
        y = inv_diag * matvec(x)
        x = y / torch.clamp(torch.linalg.vector_norm(y, dim=-1, keepdim=True), min=1e-12)
    y = inv_diag * matvec(x)
    rho = torch.sum(x * y, -1, keepdim=True)
    omega = 0.85 / torch.clamp(rho, min=1.0)

    # warm start: contacts keep their candidate ids across steps, so the
    # previous impulses project straight onto the new basis
    if prev_imp is not None and C > 0:
        basis = torch.stack([cnormal, t1, t2], 2)  # (B, C, 3, 3)
        lam_c0 = torch.einsum("bcik,bck->bci", basis, prev_imp).reshape(B, C * 3)
        lam0 = torch.cat([lam_c0, qvel_pred.new_zeros(B, L)], 1)
        # inactive rows have inv_diag == 0 and would carry a frozen warm-start
        # impulse through the iteration; mask them out up front
        lam0 = project(lam0) * arow
    else:
        lam0 = qvel_pred.new_zeros(B, R)

    # APGD with Nesterov momentum beta_k = k/(k+3) and a per-env gradient
    # restart (O'Donoghue & Candes) when the update opposes progress
    lam, y = lam0, lam0
    k = qvel_pred.new_zeros(B, 1)
    for _ in range(model.solver_iterations):
        lam_prev = lam
        r = matvec(y) + v0 - target
        lam = project(y - omega * inv_diag * r)
        restart = torch.sum((y - lam) * (lam - lam_prev), -1, keepdim=True) > 0.0
        k = torch.where(restart, 0.0, k + 1.0)
        y = lam + k / (k + 3.0) * (lam - lam_prev)
    lam = lam * arow  # deactivated rows report zero impulse

    qvel_new = qvel_pred + torch.bmm(W, lam[..., None])[..., 0]

    if C > 0:
        lam_c = lam[:, : C * 3].reshape(B, C, 3)
        basis = torch.stack([cnormal, t1, t2], 2)
        impulse = torch.einsum("bcik,bci->bck", basis, lam_c)  # world impulse on body2
        if compact:
            full = torch.zeros(B, C_full, 3, device=dev).scatter(
                1, idx[..., None].expand(B, K, 3), impulse
            )
            # truncation counter: live candidates NOT among the K gathered
            n_live = torch.sum(contact.depth > 0.0, 1)
            overflow = torch.clamp(n_live - K, min=0).to(torch.int32)
            contact = contact.replace(impulse=full, overflow=overflow)
        else:
            contact = contact.replace(
                impulse=impulse, overflow=torch.zeros(B, dtype=torch.int32, device=dev)
            )
    return qvel_new, contact
