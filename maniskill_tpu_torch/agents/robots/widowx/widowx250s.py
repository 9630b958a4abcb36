"""WidowX-250S agents (counterpart of
maniskill_tpu/agents/robots/widowx/widowx250s.py).

The arm shares the compact Trossen WidowX description of the WidowX AI (the
public WX-250S and widowx-ai geometry differ mainly in the mount plate; the
joint names and limits match). The two bridge uids pin the BridgeData v2
evaluation cameras (Logitech C920 intrinsics, mounted on ``base_link``) and
the SIMPLER real2sim-tuned PD gains.
"""
from __future__ import annotations

import numpy as np

from ....sensors.camera import CameraConfig
from ...controllers import PDEEPoseControllerConfig, PDJointPosMimicControllerConfig
from ...registration import register_agent
from ..widowxai.widowxai import ARM_JOINT_NAMES, GRIPPER_JOINT_NAMES, WidowXAI

# the Logitech C920 intrinsics of every bridge evaluation camera
BRIDGE_INTRINSIC = np.array([[623.588, 0, 319.501], [0, 623.588, 239.545], [0, 0, 1]])


@register_agent()
class WidowX250S(WidowXAI):
    uid = "widowx250s"


@register_agent()
class WidowX250SBridgeDatasetFlatTable(WidowX250S):
    """The real2sim-tuned WidowX-250S of the flat-table bridge setup."""

    uid = "widowx250s_bridgedataset_flat_table"

    # the SIMPLER-tuned gains
    arm_stiffness = np.array([1169.79, 730.0, 808.46, 1229.13, 1272.28, 1056.33])
    arm_damping = np.array([330.0, 180.0, 152.12, 309.62, 201.05, 269.51])
    arm_force_limit = np.array([200, 200, 100, 100, 100, 100])
    gripper_stiffness = 1000.0
    gripper_damping = 200.0
    gripper_force_limit = 60.0
    # the camera of the bridge dataset, on base_link
    camera_pose = np.array([0.00, -0.16, 0.36, 0.8992917, -0.09263245, 0.35892478, 0.23209205])

    @property
    def _sensor_configs(self):
        return [CameraConfig(uid="3rd_view_camera", pose=self.camera_pose, width=640, height=480,
                             intrinsic=BRIDGE_INTRINSIC, near=0.01, far=10, mount=self.robot.links_map["base_link"])]

    @property
    def _controller_configs(self):
        # the unnormalized end-effector target-delta pose, and the mimic
        # gripper with a little extra clearance
        extra_gripper_clearance = 0.001
        arm = PDEEPoseControllerConfig(
            joint_names=ARM_JOINT_NAMES, pos_lower=-1.0, pos_upper=1.0, rot_lower=-np.pi / 2, rot_upper=np.pi / 2,
            stiffness=self.arm_stiffness, damping=self.arm_damping, force_limit=self.arm_force_limit,
            ee_link="ee_gripper_link", use_delta=True, use_target=True, normalize_action=False,
        )
        gripper = PDJointPosMimicControllerConfig(
            joint_names=GRIPPER_JOINT_NAMES, lower=0.015 - extra_gripper_clearance,
            upper=0.037 + extra_gripper_clearance, stiffness=self.gripper_stiffness, damping=self.gripper_damping,
            force_limit=self.gripper_force_limit, normalize_action=True,
        )
        return dict(arm_pd_ee_target_delta_pose_align2_gripper_pd_joint_pos=dict(arm=arm, gripper=gripper))


@register_agent()
class WidowX250SBridgeDatasetSink(WidowX250SBridgeDatasetFlatTable):
    """The sink setup's camera."""

    uid = "widowx250s_bridgedataset_sink"
    camera_pose = np.array([-0.00300001, -0.21, 0.39, -0.907313, 0.0782, -0.36434, -0.194741])
