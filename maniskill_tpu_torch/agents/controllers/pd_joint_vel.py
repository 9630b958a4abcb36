"""PD joint velocity controller (counterpart of
maniskill_tpu/agents/controllers/pd_joint_vel.py): the action sets the
drives' velocity targets; the drives have no stiffness."""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Union

import numpy as np
import torch

from ...utils import gym_utils
from .base_controller import BaseController, ControllerConfig


@dataclasses.dataclass
class PDJointVelControllerConfig(ControllerConfig):
    joint_names: List[str] = None
    lower: Union[float, Sequence[float]] = -1.0
    upper: Union[float, Sequence[float]] = 1.0
    damping: Union[float, Sequence[float]] = 10.0
    force_limit: Union[float, Sequence[float]] = 1e10
    normalize_action: bool = True

    @property
    def controller_cls(self):
        return PDJointVelController


class PDJointVelController(BaseController):
    def _action_dim(self) -> int:
        return len(self.config.joint_names)

    def _initialize_action_space(self):
        n = self._action_dim()
        lo = np.broadcast_to(np.asarray(self.config.lower, np.float32), (n,)).copy()
        hi = np.broadcast_to(np.asarray(self.config.upper, np.float32), (n,)).copy()
        self._lo_t = torch.as_tensor(lo, device=self.scene.device)
        self._hi_t = torch.as_tensor(hi, device=self.scene.device)
        if self.config.normalize_action:
            self._action_space = gym_utils.Box(-1.0, 1.0, (n,), np.float32)
        else:
            self._action_space = gym_utils.Box(lo, hi, dtype=np.float32)

    def set_drive_property(self):
        n = len(self.joints)
        kd = np.broadcast_to(np.asarray(self.config.damping, np.float32), (n,))
        fl = np.broadcast_to(np.asarray(self.config.force_limit, np.float32), (n,))
        self.scene.set_drive_properties(self.dof_adrs.cpu().numpy(), np.zeros(n, np.float32), kd, fl)

    def reset(self):
        """Zero the velocity targets of the resetting envs."""
        d = self.scene.data
        zeros = torch.zeros(self.scene.num_envs, len(self.joints), device=self.scene.device)
        self.scene.data = d.replace(
            drive_vel_target=self.scene.write_cols(d.drive_vel_target, self.dof_adrs, zeros)
        )

    def set_action(self, action: torch.Tensor):
        action = action.to(torch.float32)
        if self.config.normalize_action:
            action = self._clip_and_scale_action(action, self._lo_t, self._hi_t)
        d = self.scene.data
        target = d.drive_vel_target.clone()
        target[:, self.dof_adrs] = action.expand(self.scene.num_envs, len(self.joints))
        self.scene.data = d.replace(drive_vel_target=target)
