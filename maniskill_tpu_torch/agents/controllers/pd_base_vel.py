"""PD base velocity controllers (counterpart of
maniskill_tpu/agents/controllers/pd_base_vel.py).

Ego-centric planar control of a mobile base whose first three joints are
[root_x, root_y, root_yaw]: the action, in the robot's frame, is rotated by
each env's current yaw (read from ``qpos`` on the device every step) into
the velocity targets of the x, y and yaw joints. No host sync.
"""
from __future__ import annotations

import dataclasses

import torch

from .pd_joint_vel import PDJointVelController, PDJointVelControllerConfig


@dataclasses.dataclass
class PDBaseVelControllerConfig(PDJointVelControllerConfig):
    @property
    def controller_cls(self):
        return PDBaseVelController


class PDBaseVelController(PDJointVelController):
    """Holonomic base: action [vx, vy, wz] in the robot's frame."""

    ACTION_DIM = 3

    def _action_dim(self) -> int:
        return self.ACTION_DIM

    def _initialize_action_space(self):
        super()._initialize_action_space()
        self._yaw_q = int(self.joints[2].q_adr)
        self._xyz_dofs = self.dof_adrs[:3]

    def _ego_velocity(self, action: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        vx = action[..., 0] * c - action[..., 1] * s
        vy = action[..., 0] * s + action[..., 1] * c
        return torch.stack([vx, vy, action[..., 2]], -1)

    def set_action(self, action: torch.Tensor):
        action = action.to(torch.float32)
        if self.config.normalize_action:
            action = self._clip_and_scale_action(action, self._lo_t, self._hi_t)
        scene = self.scene
        d = scene.data
        yaw = d.qpos[:, self._yaw_q]
        vel = self._ego_velocity(action, torch.cos(yaw), torch.sin(yaw))
        vel = vel.expand(scene.num_envs, 3)
        scene.data = d.replace(drive_vel_target=scene.write_cols(d.drive_vel_target, self._xyz_dofs, vel))


@dataclasses.dataclass
class PDBaseForwardVelControllerConfig(PDJointVelControllerConfig):
    @property
    def controller_cls(self):
        return PDBaseForwardVelController


class PDBaseForwardVelController(PDBaseVelController):
    """Nonholonomic base: action [v_forward, wz]."""

    ACTION_DIM = 2

    def _ego_velocity(self, action: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        return torch.stack([action[..., 0] * c, action[..., 0] * s, action[..., 1]], -1)
