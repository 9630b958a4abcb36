"""Batched FK, point Jacobian and damped-least-squares IK for the
end-effector controllers and the motion planner (counterpart of
maniskill_tpu/agents/controllers/utils/kinematics.py).

Every per-joint table the Jacobian reads (axes, hinge or slide, whether the
joint moves the end link, the dof limits) is built once on the scene's
device when the object is made, so a call copies nothing from the host. The
linear solves use a Cholesky factor from ``cholesky_ex`` and two triangular
solves: ``torch.linalg.solve`` checks its pivots on the host and so would
synchronize the stream on CUDA.
"""
from __future__ import annotations

import numpy as np
import torch

from ....physics.kinematics import forward_kinematics_raw
from ....physics.types import HINGE
from ....utils.geometry import rotation_conversions as rc


def arm_kinematics(scene, articulation, end_link_name: str, joint_names) -> "Kinematics":
    """The ``Kinematics`` of this arm, built once per articulation and then
    shared (the controller and the motion planner use the same tables), so a
    later user copies nothing to the device."""
    cache = articulation.__dict__.setdefault("_kinematics", {})
    key = (end_link_name, tuple(joint_names))
    if key not in cache:
        cache[key] = Kinematics(scene, articulation, end_link_name, joint_names)
    return cache[key]


class Kinematics:
    def __init__(self, scene, articulation, end_link_name: str, joint_names):
        self.scene = scene
        self.articulation = articulation
        links = articulation.links_map
        self.end_link = links[end_link_name] if end_link_name in links else links[end_link_name.split(":")[-1]]
        joints = [
            articulation.joints_map[n] if n in articulation.joints_map
            else next(j for j in articulation.joints if j.name.endswith(n))
            for n in joint_names
        ]
        model = scene.model
        dev = scene.device
        self.q_adrs = np.array([j.q_adr for j in joints], np.int64)
        self.dof_adrs = np.array([j.dof_adr for j in joints], np.int64)
        self.joint_bodies = np.array([j.body_id for j in joints], np.int64)
        eb = self.end_link.body_id
        self.end_body = eb
        self.q_idx = torch.as_tensor(self.q_adrs, device=dev)
        self.dof_idx = torch.as_tensor(self.dof_adrs, device=dev)
        self._jb = torch.as_tensor(self.joint_bodies, device=dev)
        self._is_hinge = torch.as_tensor(
            np.asarray(model.body_jnt_type)[self.joint_bodies] == HINGE, device=dev
        )[:, None]
        self._on_chain = torch.as_tensor(
            np.asarray(model.ancestor_mask, np.float32)[eb, self.dof_adrs], device=dev
        )[:, None]
        self._axis_l = model.jnt_axis[..., self._jb, :]
        lim = model.dof_limit[..., self.dof_idx, :]
        self._lo, self._hi = lim[..., 0], lim[..., 1]
        mid = 0.5 * (self._lo + self._hi)
        # the nullspace pull toward mid-range, zero for unlimited dofs
        self._mid = torch.where(torch.isfinite(mid), mid, torch.zeros_like(mid))
        self._has_mid = torch.isfinite(mid)

    def ee_pose(self, data) -> torch.Tensor:
        """(B, 7) world pose of the end link in ``data``."""
        b = self.end_body
        return torch.cat([data.xpos[:, b], data.xquat[:, b]], -1)

    def _fk(self, q_arm: torch.Tensor):
        """World body poses (xpos, xquat) of the scene's state with the arm
        joints replaced by ``q_arm`` (B, n)."""
        data = self.scene.data
        qpos = data.qpos.clone()
        qpos[:, self.q_idx] = q_arm
        xpos, xquat, _, _ = forward_kinematics_raw(self.scene.model, qpos, data.qvel)
        return xpos, xquat

    def _jacobian(self, xpos: torch.Tensor, xquat: torch.Tensor) -> torch.Tensor:
        """End-link point Jacobian (B, 6, n): rows [linear(3), angular(3)];
        a joint that does not move the end link has a zero column."""
        p_ee = xpos[:, self.end_body]
        axis_w = rc.quaternion_apply(xquat[:, self._jb], self._axis_l.expand(xpos.shape[0], -1, 3))
        anchor = xpos[:, self._jb]
        lin = torch.where(self._is_hinge, rc.cross(axis_w, p_ee[:, None] - anchor), axis_w)
        rot = torch.where(self._is_hinge, axis_w, torch.zeros_like(axis_w))
        return torch.cat([lin * self._on_chain, rot * self._on_chain], -1).transpose(1, 2)

    def compute_ik(
        self,
        target_pose: torch.Tensor,  # (B, 7)
        q0: torch.Tensor,  # (B, n) initial arm joints
        pos_only: bool = False,
        iterations: int = 8,
        damping: float = 0.05,
    ) -> torch.Tensor:
        """Damped least squares from ``q0`` toward ``target_pose``. Each
        iterate gets a nullspace pull of the dofs toward mid-range and is
        clamped to the dof limits, so large reorientations do not converge to
        solutions outside the limits."""
        tp, tq = target_pose[:, :3], target_pose[:, 3:]
        eb = self.end_body
        q = q0
        eye = None
        for _ in range(iterations):
            xpos, xquat = self._fk(q)
            e_pos = tp - xpos[:, eb]
            J = self._jacobian(xpos, xquat)
            if pos_only:
                err, J = e_pos, J[:, :3]
            else:
                e_rot = rc.quaternion_to_axis_angle(
                    rc.quaternion_multiply(tq, rc.quaternion_conjugate(xquat[:, eb]))
                )
                err = torch.cat([e_pos, e_rot], -1)
            if eye is None:
                eye = (damping ** 2) * torch.eye(J.shape[1], dtype=J.dtype, device=J.device)
            JJt = J @ J.mT + eye
            bias = torch.where(self._has_mid, self._mid - q, torch.zeros_like(q)) * 0.2
            Jb = (J @ bias[..., None])[..., 0]
            # both right-hand sides (the error and the projected bias) share
            # one factorization of J J^T + lambda^2 I
            L, _ = torch.linalg.cholesky_ex(JJt)
            rhs = torch.stack([err, Jb], -1)
            y = torch.linalg.solve_triangular(
                L.mT, torch.linalg.solve_triangular(L, rhs, upper=False), upper=True
            )
            Jty = J.mT @ y  # (B, n, 2)
            q = torch.minimum(torch.maximum(q + Jty[..., 0] + (bias - Jty[..., 1]), self._lo), self._hi)
        return q
