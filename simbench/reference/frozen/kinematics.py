# Frozen copy of maniskill_tpu_torch/physics/kinematics.py at the benchmark's first version:
# the benchmark's plain reference. It imports nothing of the program and is
# never edited to follow it.
"""Forward kinematics, velocity propagation and Jacobian building blocks
(counterpart of maniskill_tpu/physics/kinematics.py).

The kinematic forest is processed level by level (all bodies at one tree
depth in one batched op), so the sequential chain length is the tree depth,
not the body count. Everything is batch-first: (B, nbody, 3|4). The
reference's component-form (batch-last) variants exist only for the TPU's
(8, 128) tiling and have no counterpart here.

Conventions:
- world body = index 0 (STATIC, FIXED joint), pose = identity.
- FREE bodies store their world pose in qpos[adr:adr+7] = [p, q_wxyz] and
  world-frame velocity in qvel[adr:adr+6] = [v_origin, omega].
- ``cvel`` = (B, nbody, 6) world-frame [v_origin(3), omega(3)].
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import rotation_conversions as rc
from .plan import model_plan
from .types import Data, Model

def _gb(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather model parameters on the body/geom axis, tolerating an optional
    leading env axis (heterogeneous per-env parameters)."""
    return arr[..., idx, :] if arr.ndim >= 2 else arr[..., idx]


def _aa_to_quat(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> unit quaternion, Taylor-stable near zero (the
    reference kinematics' own form, cf.aa_to_quat_c)."""
    sq = torch.sum(axis_angle * axis_angle, dim=-1)
    ang = torch.sqrt(torch.clamp(sq, min=1e-18))
    half = 0.5 * ang
    sinc = torch.where(sq < 1e-12, 0.5 - sq / 48.0, torch.sin(half) / torch.clamp(ang, min=1e-18))
    return torch.cat([torch.cos(half)[..., None], axis_angle * sinc[..., None]], -1)


def forward_kinematics_raw(model: Model, qpos: torch.Tensor, qvel: torch.Tensor):
    """qpos (B, nq), qvel (B, nv) -> (xpos (B,nb,3), xquat (B,nb,4),
    v (B,nb,3), w (B,nb,3)) in world frame."""
    B = qpos.shape[0]
    nb = model.nbody
    plan = model_plan(model)
    xpos = qpos.new_zeros(B, nb, 3)
    xquat = qpos.new_zeros(B, nb, 4)
    xquat[..., 0] = 1.0
    v = qpos.new_zeros(B, nb, 3)
    w = qpos.new_zeros(B, nb, 3)

    if plan.n_free:
        qf = qpos[:, plan.free_q_idx]  # (B, F, 7)
        vf = qvel[:, plan.free_v_idx]  # (B, F, 6)
        xpos[:, plan.free] = qf[..., :3]
        xquat[:, plan.free] = qf[..., 3:]
        v[:, plan.free] = vf[..., :3]
        w[:, plan.free] = vf[..., 3:]

    for lv in plan.levels:
        bl, pl = lv["bodies"], lv["parents"]
        pp, pq, vp, om_p = xpos[:, pl], xquat[:, pl], v[:, pl], w[:, pl]
        fp = pp + rc.quaternion_apply(pq, _gb(model.body_pos, bl))
        fq = rc.quaternion_multiply(pq, _gb(model.body_quat, bl))
        vv = vp + rc.cross(om_p, fp - pp)

        q = (qpos[:, lv["q_idx"]] * lv["has_q"])[..., None]  # (B, L, 1)
        qd = (qvel[:, lv["v_idx"]] * lv["has_q"])[..., None]
        axis_l = _gb(model.jnt_axis, bl).expand(fp.shape)
        axis_w = rc.quaternion_apply(fq, axis_l)

        hinge, slide = lv["is_hinge"], lv["is_slide"]
        jq = _aa_to_quat(axis_l * q)
        xpos[:, bl] = torch.where(slide, fp + axis_w * q, fp)
        xquat[:, bl] = torch.where(hinge, rc.quaternion_multiply(fq, jq), fq)
        w[:, bl] = torch.where(hinge, om_p + axis_w * qd, om_p)
        v[:, bl] = torch.where(
            slide, vv + rc.cross(om_p, axis_w * q) + axis_w * qd, vv
        )
    return xpos, xquat, v, w


def forward_kinematics(model: Model, data: Data) -> Data:
    """qpos -> world body poses (xpos, xquat) and velocities (cvel)."""
    xpos, xquat, v, w = forward_kinematics_raw(model, data.qpos, data.qvel)
    if model.mocap_bodies is not None and data.mocap_pose is not None:
        # dof-less marker bodies: splice their per-env poses in
        mb = model_plan(model).mocap
        xpos[:, mb] = data.mocap_pose[..., :3]
        xquat[:, mb] = data.mocap_pose[..., 3:7]
    return data.replace(xpos=xpos, xquat=xquat, cvel=torch.cat([v, w], -1))


def dof_frames_from(model: Model, xpos: torch.Tensor, xquat: torch.Tensor):
    """Per-dof world axis and anchor: (B, nv, 3) each. Rotational dofs rotate
    about (axis, anchor); translational dofs translate along axis. FREE
    joints: 3 world-axis translations + 3 rotations about the body origin."""
    plan = model_plan(model)
    db = plan.dof_body
    anchor = xpos[:, db]
    axis_l = _gb(model.jnt_axis, db).expand(anchor.shape)
    axis_w = rc.quaternion_apply(xquat[:, db], axis_l)
    return torch.where(plan.is_free_dof, plan.const_axis, axis_w), anchor


def dof_frames(model: Model, data: Data) -> Tuple[torch.Tensor, torch.Tensor]:
    return dof_frames_from(model, data.xpos, data.xquat)


def body_com(model: Model, data: Data) -> torch.Tensor:
    return data.xpos + rc.quaternion_apply(data.xquat, model.body_ipos)


def body_jacobians(model: Model, data: Data, dof_axis: torch.Tensor, dof_anchor: torch.Tensor):
    """COM-point translational + rotational Jacobians for all bodies:
    (jac_lin (B, nbody, nv, 3), jac_rot (B, nbody, nv, 3))."""
    plan = model_plan(model)
    com = body_com(model, data)
    is_rot = plan.dof_is_rot[None, None, :, None]
    rel = com[:, :, None, :] - dof_anchor[:, None, :, :]  # (B, nb, nv, 3)
    axis = dof_axis[:, None].expand(rel.shape)
    jac_lin = torch.where(is_rot, rc.cross(axis, rel), axis)
    jac_rot = torch.where(is_rot, axis, torch.zeros_like(axis))
    m = (plan.ancestor * plan.dyn[:, None])[None, :, :, None]
    return jac_lin * m, jac_rot * m


def geom_poses_from(model: Model, xpos: torch.Tensor, xquat: torch.Tensor):
    """World poses of all geoms: (B, ngeom, 3), (B, ngeom, 4). ``geom_pos``
    may be shared (ngeom, 3) or per env (B, ngeom, 3); it is read from the
    model on each call, so a table written after the plan exists applies."""
    gb = model_plan(model).geom_body
    bp, bq = xpos[:, gb], xquat[:, gb]
    pos = bp + rc.quaternion_apply(bq, model.geom_pos)
    quat = rc.quaternion_multiply(bq, model.geom_quat.expand(bq.shape))
    return pos, quat


def geom_poses(model: Model, data: Data) -> Tuple[torch.Tensor, torch.Tensor]:
    return geom_poses_from(model, data.xpos, data.xquat)
