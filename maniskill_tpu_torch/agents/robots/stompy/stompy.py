"""Stompy humanoid (counterpart of maniskill_tpu/agents/robots/stompy/stompy.py),
loaded from the port's copy of the generated compact URDF: a free root, a
35-dof primitive-geometry body, a head camera and one controller over every
active joint."""
from __future__ import annotations

import os

import numpy as np

from .... import PACKAGE_ASSET_DIR
from ....sensors.camera import CameraConfig
from ...base_agent import BaseAgent, Keyframe
from ...controllers import PDJointPosControllerConfig
from ...registration import register_agent


@register_agent()
class Stompy(BaseAgent):
    uid = "stompy"
    urdf_path = os.path.join(PACKAGE_ASSET_DIR, "robots", "stompy", "stompy.urdf")
    fix_root_link = False
    disable_self_collisions = True

    keyframes = dict(standing=Keyframe(pose=np.array([0, 0, 0.78, 1, 0, 0, 0]), qpos=np.zeros(35)))

    @property
    def _controller_configs(self):
        names = [j.name for j in self.robot.active_joints]
        return dict(
            pd_joint_pos=dict(
                body=PDJointPosControllerConfig(joint_names=names, lower=None, upper=None, stiffness=100, damping=10,
                                                normalize_action=False),
                balance_passive_force=False,
            ),
            pd_joint_delta_pos=dict(
                body=PDJointPosControllerConfig(joint_names=names, lower=-0.1, upper=0.1, stiffness=20, damping=5,
                                                normalize_action=True, use_delta=True),
                balance_passive_force=False,
            ),
        )

    @property
    def _sensor_configs(self):
        q = np.array([0.5, -0.5, 0.5, -0.5])  # -pi/2 about x: looking forward
        return [CameraConfig(uid="head_camera", pose=np.concatenate([[0.12, 0, 0.02], q]), width=128, height=128,
                             fov=1.57, near=0.01, far=100, mount=self.robot.links_map["link_head_1_head_1"])]
