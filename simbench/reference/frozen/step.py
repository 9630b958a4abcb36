# Frozen copy of maniskill_tpu_torch/physics/step.py at the benchmark's first version:
# the benchmark's plain reference. It imports nothing of the program and is
# never edited to follow it.
"""Physics step (counterpart of maniskill_tpu/physics/step.py).

``step(model, data) -> data`` advances one substep; the env runs the
substeps of a control step as a Python loop.
"""
from __future__ import annotations

import torch

from . import rotation_conversions as rc
from .collision import collide
from .drives import drive_wrenches
from .dynamics import smooth_dynamics
from .kinematics import forward_kinematics, forward_kinematics_raw
from .plan import model_plan
from .solver import solve
from .types import Data, Model


def forward(model: Model, data: Data) -> Data:
    """Refresh derived quantities (FK + contacts) without advancing time."""
    data = forward_kinematics(model, data)
    return data.replace(contact=collide(model, data))


def step(model: Model, data: Data) -> Data:
    """Advance one physics substep (semi-implicit Euler).

    Kinematics are computed once and shared by dynamics, collision and the
    solver. The returned Data's xpos/xquat/cvel are NOT refreshed (nothing
    inside a substep reads them; the env runs ``forward_kinematics`` after
    the substeps).
    """
    kin = forward_kinematics_raw(model, data.qpos, data.qvel)
    if model.drive6_body1 is not None and len(model.drive6_body1):
        data = data.replace(xfrc_applied=data.xfrc_applied + drive_wrenches(model, data, kin))
    Minv, qvel_pred, qacc = smooth_dynamics(model, data, kin)
    contact = collide(model, data, kin)
    qvel_new, contact = solve(model, data, Minv, qvel_pred, contact, kin)
    # safety rail: bound velocities so one bad solve cannot cascade to inf
    qvel_new = torch.clamp(qvel_new, -model.max_qvel, model.max_qvel)
    return data.replace(
        qpos=integrate_qpos(model, data.qpos, qvel_new, model.timestep),
        qvel=qvel_new,
        qacc=qacc,
        contact=contact,
        # one-shot external forces are consumed by the step
        qf_applied=torch.zeros_like(data.qf_applied),
        xfrc_applied=torch.zeros_like(data.xfrc_applied),
    )


def integrate_qpos(model: Model, qpos: torch.Tensor, qvel: torch.Tensor, h: float) -> torch.Tensor:
    """Semi-implicit Euler position update (exact quaternion exp for
    rotations): one gather/scatter for all 1-dof joints, one batched
    quaternion integration for all FREE bodies."""
    plan = model_plan(model)
    out = qpos.clone()
    if len(plan.one_q):
        out[:, plan.one_q] += h * qvel[:, plan.one_v]
    if plan.n_free:
        qp = qpos[:, plan.free_q_idx]  # (B, F, 7)
        vv = qvel[:, plan.free_v_idx]  # (B, F, 6)
        p = qp[..., :3] + h * vv[..., :3]
        q = rc.integrate_quaternion(qp[..., 3:7], vv[..., 3:6], h)
        out[:, plan.free_q_idx] = torch.cat([p, q], -1)
    return out
