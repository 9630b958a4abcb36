"""xArm6 without a gripper (counterpart of
maniskill_tpu/agents/robots/xarm6/xarm6_nogripper.py), loaded from the
port's copy of the compact URDF."""
from __future__ import annotations

import os

import numpy as np
import torch

from .... import PACKAGE_ASSET_DIR
from ...base_agent import BaseAgent, Keyframe
from ...controllers import PDEEPoseControllerConfig, PDJointPosControllerConfig
from ...registration import register_agent

ARM_JOINT_NAMES = [f"joint{i}" for i in range(1, 7)]


@register_agent()
class XArm6NoGripper(BaseAgent):
    uid = "xarm6_nogripper"
    urdf_path = os.path.join(PACKAGE_ASSET_DIR, "robots", "xarm6", "xarm6_nogripper.urdf")
    fix_root_link = True
    disable_self_collisions = True

    keyframes = dict(rest=Keyframe(qpos=np.array([0, 0.22, -1.23, 0, 1.01, 0]), pose=np.array([0, 0, 0, 1, 0, 0, 0])))

    arm_stiffness = 1e3
    arm_damping = 1e2
    arm_force_limit = 100

    @property
    def _controller_configs(self):
        arm_common = dict(joint_names=ARM_JOINT_NAMES, stiffness=self.arm_stiffness, damping=self.arm_damping,
                          force_limit=self.arm_force_limit)
        pd_joint_pos = PDJointPosControllerConfig(**arm_common, lower=None, upper=None, normalize_action=False)
        pd_joint_delta_pos = PDJointPosControllerConfig(**arm_common, lower=-0.1, upper=0.1, use_delta=True)
        pd_ee_delta_pose = PDEEPoseControllerConfig(**arm_common, pos_lower=-0.1, pos_upper=0.1, rot_lower=-0.1,
                                                    rot_upper=0.1, ee_link="link_tcp", use_delta=True)
        return dict(
            pd_joint_delta_pos=dict(arm=pd_joint_delta_pos),
            pd_joint_pos=dict(arm=pd_joint_pos),
            pd_ee_delta_pose=dict(arm=pd_ee_delta_pose),
        )

    def _after_init(self):
        self.tcp = self.robot.links_map["link_tcp"]

    @property
    def tcp_pose(self):
        return self.tcp.pose

    def is_grasping(self, object=None, min_force=0.5, max_angle=85):
        return torch.zeros(self.scene.num_envs, dtype=torch.bool, device=self.scene.device)

    def is_static(self, threshold: float = 0.2):
        return torch.amax(torch.abs(self.robot.qvel), 1) <= threshold
