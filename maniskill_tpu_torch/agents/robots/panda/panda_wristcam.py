"""PandaWristCam (counterpart of
maniskill_tpu/agents/robots/panda/panda_wristcam.py): the Panda with a
hand-mounted camera. ``camera_link`` is a fixed frame on the hand, looking at
the fingers (x forward, the ROS convention)."""
from __future__ import annotations

import numpy as np

from ....building.articulation_builder import LinkSpec
from ....physics.types import FIXED
from ....sensors.camera import CameraConfig
from ...registration import register_agent
from .panda import Panda, _rpy


@register_agent()
class PandaWristCam(Panda):
    uid = "panda_wristcam"

    def build_description(self):
        b = super().build_description()
        b.add_link(
            LinkSpec(
                "camera_link", "panda_hand", joint_type=FIXED,
                joint_name="camera_joint",
                origin_pos=(0.05, 0.0, 0.01),
                origin_quat=_rpy(0, np.pi / 2 + np.deg2rad(20), 0),
                mass=1e-4, inertia=np.full(3, 1e-8),
            )
        )
        return b

    @property
    def _sensor_configs(self):
        return [
            CameraConfig(
                "hand_camera",
                pose=np.array([0, 0, 0, 1, 0, 0, 0]),
                width=128, height=128, fov=np.pi / 2, near=0.01, far=100,
                mount=self.robot.links_map["camera_link"],
            )
        ]
