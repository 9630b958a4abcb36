"""Wrist-camera variants of the xArm6 agents (counterpart of
maniskill_tpu/agents/robots/xarm6/xarm6_wristcam.py): a hand camera near
the end effector, x-forward."""
from __future__ import annotations

import numpy as np

from ....sensors.camera import CameraConfig
from ...registration import register_agent
from .xarm6_nogripper import XArm6NoGripper
from .xarm6_robotiq import XArm6Robotiq

# below the wrist, pitched to look past the fingers
_CAM_POSE = np.array([0.0, 0.0, -0.05, 0.70710678, 0.0, 0.70710678, 0.0])


def _hand_camera(mount):
    return [CameraConfig(uid="hand_camera", pose=_CAM_POSE, width=128, height=128, fov=np.pi / 2, near=0.01,
                         far=100, mount=mount)]


@register_agent()
class XArm6RobotiqWristCamera(XArm6Robotiq):
    uid = "xarm6_robotiq_wristcam"

    @property
    def _sensor_configs(self):
        return _hand_camera(self.robot.links_map["robotiq_base"])


@register_agent()
class XArm6NoGripperWristCamera(XArm6NoGripper):
    uid = "xarm6_nogripper_wristcam"

    @property
    def _sensor_configs(self):
        return _hand_camera(self.robot.links_map["link6"])
