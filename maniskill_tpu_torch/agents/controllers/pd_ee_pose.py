"""PD end-effector position and pose controllers (counterpart of
maniskill_tpu/agents/controllers/pd_ee_pose.py).

An action is an end-effector delta (or, with ``use_delta=False``, an
absolute target in the robot-root frame); damped-least-squares IK turns it
into joint PD targets. Frames follow the reference: translation deltas in
the robot-root frame, rotation deltas about the end-effector origin with
root-aligned axes. With ``use_target`` the delta is
taken from the pose that FK of the persisted joint targets gives. Zero
deltas do not hold that pose exactly: the IK's nullspace bias toward the
joints' mid-range leaks into the task space through the damping (by
lambda^2 (J J^T + lambda^2 I)^-1 J b per iteration), so the TCP drifts
about 1.2 mm per control step, as it does in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ...utils.geometry import rotation_conversions as rc
from .pd_joint_pos import PDJointPosController, PDJointPosControllerConfig
from .utils.kinematics import Kinematics, arm_kinematics


@dataclasses.dataclass
class PDEEPosControllerConfig(PDJointPosControllerConfig):
    ee_link: Optional[str] = None
    use_delta: bool = True
    normalize_action: bool = True
    pos_lower: float = -0.1
    pos_upper: float = 0.1

    @property
    def controller_cls(self):
        return PDEEPosController


class PDEEPosController(PDJointPosController):
    config: PDEEPosControllerConfig
    _action_dim = 3

    def _action_bounds(self):
        n = self._action_dim
        return np.full(n, self.config.pos_lower), np.full(n, self.config.pos_upper)

    @property
    def ee_pose(self):
        """The end link's world pose."""
        return self.kinematics.end_link.pose

    @property
    def ee_pose_at_base(self):
        """The end link's pose in the robot-root frame."""
        return self.articulation.root_pose.inv() * self.ee_pose

    @property
    def kinematics(self) -> Kinematics:
        """Built at the first use, when the scene's model is final."""
        return arm_kinematics(self.scene, self.articulation, self.config.ee_link, self.config.joint_names)

    def _ref_ee_pq(self):
        """The pose deltas compose onto, and the IK's start: the current end
        link pose and joints, or (``use_target``) FK of the drive targets."""
        if self.config.use_target:
            kin = self.kinematics
            q_prev = self.scene.data.drive_target[:, kin.dof_idx]
            xpos, xquat = kin._fk(q_prev)
            return xpos[:, kin.end_body], xquat[:, kin.end_body], q_prev
        cur = self.kinematics.end_link.pose
        return cur.p, cur.q, self.scene.data.qpos[:, self.q_adrs]

    def _target_ee_pose(self, action, cur_p, cur_q) -> torch.Tensor:
        """Action (B, A) -> world-frame target end-effector pose (B, 7)."""
        root = self.articulation.root_pose
        if not self.config.use_delta:  # an absolute position in the root frame
            return torch.cat([root.p + rc.quaternion_apply(root.q, action[..., :3]), cur_q], -1)
        return torch.cat([cur_p + rc.quaternion_apply(root.q, action[..., :3]), cur_q], -1)

    def set_action(self, action: torch.Tensor):
        action = action.to(torch.float32)
        if self.config.normalize_action:
            action = self._clip_and_scale_action(action, self._lo_t, self._hi_t)
        action = action.expand(self.scene.num_envs, self._action_dim)
        cur_p, cur_q, q0 = self._ref_ee_pq()
        target = self._target_ee_pose(action, cur_p, cur_q)
        q_new = self.kinematics.compute_ik(target, q0, pos_only=self._action_dim == 3)
        self._set_target(torch.minimum(torch.maximum(q_new, self._lim_lo), self._lim_hi))


@dataclasses.dataclass
class PDEEPoseControllerConfig(PDEEPosControllerConfig):
    rot_lower: float = -0.1
    rot_upper: float = 0.1

    @property
    def controller_cls(self):
        return PDEEPoseController


class PDEEPoseController(PDEEPosController):
    config: PDEEPoseControllerConfig
    _action_dim = 6

    def _action_bounds(self):
        c = self.config
        lo = np.concatenate([np.full(3, c.pos_lower), np.full(3, c.rot_lower)])
        hi = np.concatenate([np.full(3, c.pos_upper), np.full(3, c.rot_upper)])
        return lo, hi

    def _target_ee_pose(self, action, cur_p, cur_q) -> torch.Tensor:
        root = self.articulation.root_pose
        root_q = root.q
        if not self.config.use_delta:  # an absolute pose in the root frame
            q = rc.quaternion_multiply(root_q, rc.axis_angle_to_quaternion(action[..., 3:]))
            return torch.cat([root.p + rc.quaternion_apply(root_q, action[..., :3]), q], -1)
        p = cur_p + rc.quaternion_apply(root_q, action[..., :3])
        # the rotation delta about the end-effector origin, root-aligned
        dq_root = rc.axis_angle_to_quaternion(action[..., 3:])
        dq_world = rc.quaternion_multiply(root_q, rc.quaternion_multiply(dq_root, rc.quaternion_conjugate(root_q)))
        return torch.cat([p, rc.quaternion_multiply(dq_world, cur_q)], -1)
