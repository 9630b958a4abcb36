"""WidowX AI (counterpart of maniskill_tpu/agents/robots/widowxai/widowxai.py),
loaded from the port's copy of the compact URDF (approximate public Trossen
WidowX frames, primitive collisions)."""
from __future__ import annotations

import os

import numpy as np
import torch

from .... import PACKAGE_ASSET_DIR
from ....utils import common
from ....utils.geometry.rotation_conversions import quaternion_apply
from ...base_agent import BaseAgent, Keyframe
from ...controllers import PDEEPoseControllerConfig, PDJointPosControllerConfig, PDJointPosMimicControllerConfig
from ...registration import register_agent

ARM_JOINT_NAMES = ["waist", "shoulder", "elbow", "forearm_roll", "wrist_angle", "wrist_rotate"]
GRIPPER_JOINT_NAMES = ["left_finger", "right_finger"]


@register_agent()
class WidowXAI(BaseAgent):
    uid = "widowxai"
    urdf_path = os.path.join(PACKAGE_ASSET_DIR, "robots", "widowxai", "widowxai.urdf")
    fix_root_link = True
    disable_self_collisions = True

    keyframes = dict(
        ready_to_grasp=Keyframe(qpos=np.array([0, 0.4, 0.6, 0, -1.0, 0, 0.037, 0.037]),
                                pose=np.array([0, 0, 0, 1, 0, 0, 0])),
        rest=Keyframe(qpos=np.array([0, 0.4, 0.6, 0, -1.0, 0, 0.037, 0.037]), pose=np.array([0, 0, 0, 1, 0, 0, 0])),
    )

    arm_stiffness = 300
    arm_damping = 30
    arm_force_limit = 30
    gripper_stiffness = 300
    gripper_damping = 30
    gripper_force_limit = 20

    @property
    def _controller_configs(self):
        arm_common = dict(joint_names=ARM_JOINT_NAMES, stiffness=self.arm_stiffness, damping=self.arm_damping,
                          force_limit=self.arm_force_limit)
        pd_joint_pos = PDJointPosControllerConfig(**arm_common, lower=None, upper=None, normalize_action=False)
        pd_joint_delta_pos = PDJointPosControllerConfig(**arm_common, lower=-0.1, upper=0.1, use_delta=True)
        pd_ee_delta_pose = PDEEPoseControllerConfig(**arm_common, pos_lower=-0.1, pos_upper=0.1, rot_lower=-0.1,
                                                    rot_upper=0.1, ee_link="ee_gripper_link", use_delta=True)
        gripper = PDJointPosMimicControllerConfig(
            joint_names=GRIPPER_JOINT_NAMES, lower=0.0, upper=0.037, stiffness=self.gripper_stiffness,
            damping=self.gripper_damping, force_limit=self.gripper_force_limit,
        )
        return dict(
            pd_joint_delta_pos=dict(arm=pd_joint_delta_pos, gripper=gripper),
            pd_joint_pos=dict(arm=pd_joint_pos, gripper=gripper),
            pd_ee_delta_pose=dict(arm=pd_ee_delta_pose, gripper=gripper),
        )

    def _after_init(self):
        self.tcp = self.robot.links_map["ee_gripper_link"]
        self.finger1_link = self.robot.links_map["left_finger_link"]
        self.finger2_link = self.robot.links_map["right_finger_link"]
        self._close_dir1 = torch.tensor([0.0, -1.0, 0.0], device=self.scene.device)
        self._close_dir2 = torch.tensor([0.0, 1.0, 0.0], device=self.scene.device)

    @property
    def tcp_pose(self):
        return self.tcp.pose

    def is_grasping(self, object, min_force=0.5, max_angle=85.0):
        l_forces = self.scene.get_pairwise_contact_forces(self.finger1_link, object)
        r_forces = self.scene.get_pairwise_contact_forces(self.finger2_link, object)
        lforce = torch.linalg.vector_norm(l_forces, dim=-1)
        rforce = torch.linalg.vector_norm(r_forces, dim=-1)
        langle = common.compute_angle_between(quaternion_apply(self.finger1_link.pose.q, self._close_dir1), l_forces)
        rangle = common.compute_angle_between(quaternion_apply(self.finger2_link.pose.q, self._close_dir2), r_forces)
        return ((lforce >= min_force) & (torch.rad2deg(langle) <= max_angle)
                & (rforce >= min_force) & (torch.rad2deg(rangle) <= max_angle))

    def is_static(self, threshold: float = 0.2):
        return torch.amax(torch.abs(self.robot.qvel[..., :-2]), 1) <= threshold
