"""Koch v1.1 low-cost arm (counterpart of
maniskill_tpu/agents/robots/koch/koch.py), loaded from the port's copy of
the compact URDF (approximate public koch-v1.1 layout, primitive
collisions)."""
from __future__ import annotations

import os

import numpy as np
import torch

from .... import PACKAGE_ASSET_DIR
from ...base_agent import BaseAgent, Keyframe
from ...controllers import PDJointPosControllerConfig
from ...registration import register_agent

JOINT_NAMES = ["shoulder_pan", "shoulder_lift", "elbow_flex", "wrist_flex", "wrist_roll", "gripper"]


@register_agent()
class Koch(BaseAgent):
    uid = "koch-v1.1"
    urdf_path = os.path.join(PACKAGE_ASSET_DIR, "robots", "koch", "koch.urdf")
    fix_root_link = True
    disable_self_collisions = True

    keyframes = dict(rest=Keyframe(qpos=np.array([0, -0.6, 1.0, 0.5, 0, -0.5]), pose=np.array([0, 0, 0, 1, 0, 0, 0])))

    @property
    def _controller_configs(self):
        common_kw = dict(joint_names=JOINT_NAMES, stiffness=50.0, damping=5.0, force_limit=5.0)
        pd_joint_pos = PDJointPosControllerConfig(**common_kw, lower=None, upper=None, normalize_action=False)
        pd_joint_delta_pos = PDJointPosControllerConfig(**common_kw, lower=-0.1, upper=0.1, use_delta=True)
        return dict(pd_joint_delta_pos=dict(arm=pd_joint_delta_pos), pd_joint_pos=dict(arm=pd_joint_pos))

    def _after_init(self):
        self.tcp = self.robot.links_map["fixed_jaw_tip"]
        self.finger1_link = self.robot.links_map["fixed_jaw_tip"]
        self.finger2_link = self.robot.links_map["moving_jaw"]

    @property
    def tcp_pose(self):
        return self.tcp.pose

    def is_grasping(self, object, min_force=0.25, max_angle=110.0):
        l_forces = self.scene.get_pairwise_contact_forces(self.finger1_link, object)
        r_forces = self.scene.get_pairwise_contact_forces(self.finger2_link, object)
        return ((torch.linalg.vector_norm(l_forces, dim=-1) >= min_force)
                & (torch.linalg.vector_norm(r_forces, dim=-1) >= min_force))

    def is_static(self, threshold: float = 0.2):
        return torch.amax(torch.abs(self.robot.qvel[..., :-1]), 1) <= threshold
