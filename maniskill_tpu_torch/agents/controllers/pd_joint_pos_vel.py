"""PD joint position-and-velocity controller (counterpart of
maniskill_tpu/agents/controllers/pd_joint_pos_vel.py): the action is
[target positions, target velocities] per joint; the positions go through
``PDJointPosController``'s rules and the velocities into the drives'
velocity targets."""
from __future__ import annotations

import dataclasses
from typing import Sequence, Union

import numpy as np
import torch

from ...utils import gym_utils
from .pd_joint_pos import PDJointPosController, PDJointPosControllerConfig


@dataclasses.dataclass
class PDJointPosVelControllerConfig(PDJointPosControllerConfig):
    vel_lower: Union[float, Sequence[float]] = -1.0
    vel_upper: Union[float, Sequence[float]] = 1.0

    @property
    def controller_cls(self):
        return PDJointPosVelController


class PDJointPosVelController(PDJointPosController):
    config: PDJointPosVelControllerConfig

    def _initialize_action_space(self):
        super()._initialize_action_space()
        n = len(self.config.joint_names)
        vlo = np.broadcast_to(np.asarray(self.config.vel_lower, np.float32), (n,))
        vhi = np.broadcast_to(np.asarray(self.config.vel_upper, np.float32), (n,))
        self._vlo_t = torch.as_tensor(vlo.copy(), device=self.scene.device)
        self._vhi_t = torch.as_tensor(vhi.copy(), device=self.scene.device)
        if self.config.normalize_action:
            self._action_space = gym_utils.Box(-1.0, 1.0, (2 * n,), np.float32)
        else:
            lo, hi = np.concatenate([self._lo, vlo]), np.concatenate([self._hi, vhi])
            self._action_space = gym_utils.Box(lo, hi, dtype=np.float32)

    def set_action(self, action: torch.Tensor):
        n = len(self.joints)
        action = action.to(torch.float32)
        pos_a, vel_a = action[..., :n], action[..., n:]
        if self.config.normalize_action:
            pos_a = self._clip_and_scale_action(pos_a, self._lo_t, self._hi_t)
            vel_a = self._clip_and_scale_action(vel_a, self._vlo_t, self._vhi_t)
        d = self.scene.data
        if self.config.use_delta:
            base = self._target_qpos() if self.config.use_target else d.qpos[:, self.q_adrs]
            target = base + pos_a
        else:
            target = pos_a.expand(self.scene.num_envs, n)
        self._set_target(torch.minimum(torch.maximum(target, self._lim_lo), self._lim_hi))
        d = self.scene.data
        vel = d.drive_vel_target.clone()
        vel[:, self.dof_adrs] = vel_a.expand(self.scene.num_envs, n)
        self.scene.data = d.replace(drive_vel_target=vel)
