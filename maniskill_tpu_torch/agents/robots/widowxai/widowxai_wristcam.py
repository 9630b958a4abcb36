"""WidowX AI with a wrist-mounted camera (counterpart of
maniskill_tpu/agents/robots/widowxai/widowxai_wristcam.py): the camera rides
the gripper link, x-forward toward the fingers."""
from __future__ import annotations

import numpy as np

from ....sensors.camera import CameraConfig
from ...registration import register_agent
from .widowxai import WidowXAI


@register_agent()
class WidowXAIWristCam(WidowXAI):
    uid = "widowxai_wristcam"

    @property
    def _sensor_configs(self):
        # pitched down from the gripper body toward the fingertips
        q = np.array([np.cos(np.pi / 8), 0, np.sin(np.pi / 8), 0])
        return [CameraConfig(uid="wrist_camera", pose=np.concatenate([[0.02, 0.0, 0.03], q]), width=128, height=128,
                             fov=np.pi / 2, near=0.01, far=100, mount=self.robot.links_map["gripper_link"])]
