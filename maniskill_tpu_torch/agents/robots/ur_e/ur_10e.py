"""UR10e arm (counterpart of maniskill_tpu/agents/robots/ur_e/ur_10e.py),
loaded from the port's copy of the compact URDF (public ur_description DH
frames)."""
from __future__ import annotations

import os

import numpy as np
import torch

from .... import PACKAGE_ASSET_DIR
from ...base_agent import BaseAgent, Keyframe
from ...controllers import PDJointPosControllerConfig
from ...registration import register_agent

JOINT_NAMES = ["shoulder_pan_joint", "shoulder_lift_joint", "elbow_joint", "wrist_1_joint", "wrist_2_joint",
               "wrist_3_joint"]


@register_agent()
class UR10e(BaseAgent):
    uid = "ur_10e"
    urdf_path = os.path.join(PACKAGE_ASSET_DIR, "robots", "ur_10e", "ur10e.urdf")
    fix_root_link = True
    disable_self_collisions = True

    keyframes = dict(rest=Keyframe(qpos=np.array([0, -np.pi / 2, np.pi / 2, -np.pi / 2, -np.pi / 2, 0]),
                                   pose=np.array([0, 0, 0, 1, 0, 0, 0])))

    arm_stiffness = 1e3
    arm_damping = 1e2
    arm_force_limit = 300

    @property
    def _controller_configs(self):
        common_kw = dict(joint_names=JOINT_NAMES, stiffness=self.arm_stiffness, damping=self.arm_damping,
                         force_limit=self.arm_force_limit)
        pd_joint_pos = PDJointPosControllerConfig(**common_kw, lower=None, upper=None, normalize_action=False)
        pd_joint_delta_pos = PDJointPosControllerConfig(**common_kw, lower=-0.1, upper=0.1, use_delta=True)
        return dict(pd_joint_delta_pos=dict(arm=pd_joint_delta_pos), pd_joint_pos=dict(arm=pd_joint_pos))

    def _after_init(self):
        self.tcp = self.robot.links_map["flange"]

    @property
    def tcp_pose(self):
        return self.tcp.pose

    def is_grasping(self, object=None, min_force=0.5, max_angle=85):
        return torch.zeros(self.scene.num_envs, dtype=torch.bool, device=self.scene.device)

    def is_static(self, threshold: float = 0.2):
        return torch.amax(torch.abs(self.robot.qvel), 1) <= threshold
