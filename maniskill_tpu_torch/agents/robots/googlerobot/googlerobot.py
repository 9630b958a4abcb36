"""Google Robot (counterpart of
maniskill_tpu/agents/robots/googlerobot/googlerobot.py), loaded from the
port's copy of the compact URDF: torso yaw, a 7-dof arm, a two-finger
gripper and head pan/tilt, with the calibrated overhead camera's intrinsics
on the head's ``link_camera``."""
from __future__ import annotations

import os

import numpy as np
import torch

from .... import PACKAGE_ASSET_DIR
from ....sensors.camera import CameraConfig
from ...base_agent import BaseAgent, Keyframe
from ...controllers import PDJointPosControllerConfig, PDJointPosMimicControllerConfig
from ...registration import register_agent

ARM_JOINT_NAMES = ["joint_torso", "joint_shoulder", "joint_bicep", "joint_elbow", "joint_forearm", "joint_wrist",
                   "joint_gripper"]
FINGER_JOINT_NAMES = ["joint_finger_left", "joint_finger_right"]
HEAD_JOINT_NAMES = ["joint_head_pan", "joint_head_tilt"]


@register_agent()
class GoogleRobot(BaseAgent):
    uid = "googlerobot"
    urdf_path = os.path.join(PACKAGE_ASSET_DIR, "robots", "googlerobot", "googlerobot.urdf")
    fix_root_link = True
    disable_self_collisions = True

    keyframes = dict(rest=Keyframe(qpos=np.array([0, -0.3, 0, 1.5, 0, -1.0, 0, 0, 0, 0.02, 0.02]),
                                   pose=np.array([0, 0, 0, 1, 0, 0, 0])))

    @property
    def _controller_configs(self):
        arm = PDJointPosControllerConfig(joint_names=ARM_JOINT_NAMES, lower=-0.1, upper=0.1, stiffness=1e3,
                                         damping=1e2, force_limit=150, use_delta=True)
        head = PDJointPosControllerConfig(joint_names=HEAD_JOINT_NAMES, lower=-0.1, upper=0.1, stiffness=300,
                                          damping=30, force_limit=20, use_delta=True)
        gripper = PDJointPosMimicControllerConfig(joint_names=FINGER_JOINT_NAMES, lower=0.0, upper=0.04,
                                                  stiffness=1e3, damping=1e2, force_limit=60)
        return dict(pd_joint_delta_pos=dict(arm=arm, head=head, gripper=gripper))

    @property
    def _sensor_configs(self):
        return [CameraConfig(uid="overhead_camera", pose=np.array([0, 0, 0, 0.5, 0.5, -0.5, 0.5]), width=640,
                             height=512, intrinsic=np.array([[425.0, 0, 305.0], [0, 413.1, 233.0], [0, 0, 1]]),
                             near=0.01, far=100, mount=self.robot.links_map["link_camera"])]

    def _after_init(self):
        self.tcp = self.robot.links_map["link_tcp"]
        self.finger1_link = self.robot.links_map["link_finger_left"]
        self.finger2_link = self.robot.links_map["link_finger_right"]

    @property
    def tcp_pose(self):
        return self.tcp.pose

    def is_grasping(self, object, min_force=0.5):
        lf = self.scene.get_pairwise_contact_forces(self.finger1_link, object)
        rf = self.scene.get_pairwise_contact_forces(self.finger2_link, object)
        return (torch.linalg.vector_norm(lf, dim=-1) >= min_force) & (torch.linalg.vector_norm(rf, dim=-1) >= min_force)
