"""TriFingerPro (counterpart of
maniskill_tpu/agents/robots/trifingerpro/trifingerpro.py).

Three 3-dof fingers at 120-degree spacing, loaded from the port's copy of
the compact URDF.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .... import PACKAGE_ASSET_DIR
from ...base_agent import BaseAgent, Keyframe
from ...controllers import PDJointPosControllerConfig, PDJointVelControllerConfig
from ...registration import register_agent

JOINT_NAMES = [f"finger_{part}_joint_{a}" for a in (0, 120, 240)
               for part in ("base_to_upper", "upper_to_middle", "middle_to_lower")]
TIP_LINK_NAMES = ["finger_tip_link_0", "finger_tip_link_120", "finger_tip_link_240"]


@register_agent()
class TriFingerPro(BaseAgent):
    uid = "trifingerpro"
    urdf_path = os.path.join(PACKAGE_ASSET_DIR, "robots", "trifinger", "trifingerpro.urdf")
    fix_root_link = True
    disable_self_collisions = True

    joint_stiffness = 1e2
    joint_damping = 1e1
    joint_force_limit = 2e1

    keyframes = dict(rest=Keyframe(qpos=np.array([0.0, 0.9, -1.7] * 3), pose=np.array([0, 0, 0, 1, 0, 0, 0])))

    @property
    def _controller_configs(self):
        common_kw = dict(joint_names=JOINT_NAMES, stiffness=self.joint_stiffness, damping=self.joint_damping,
                         force_limit=self.joint_force_limit)
        pd_joint_pos = PDJointPosControllerConfig(**common_kw, lower=None, upper=None, normalize_action=False)
        pd_joint_delta_pos = PDJointPosControllerConfig(**common_kw, lower=-0.1, upper=0.1, use_delta=True)
        pd_joint_target_delta_pos = PDJointPosControllerConfig(
            **common_kw, lower=-0.1, upper=0.1, use_delta=True, use_target=True
        )
        pd_joint_vel = PDJointVelControllerConfig(
            joint_names=JOINT_NAMES, lower=-1.0, upper=1.0, damping=self.joint_damping,
            force_limit=self.joint_force_limit,
        )
        return dict(
            pd_joint_delta_pos=dict(arm=pd_joint_delta_pos),
            pd_joint_pos=dict(arm=pd_joint_pos),
            pd_joint_target_delta_pos=dict(arm=pd_joint_target_delta_pos),
            pd_joint_vel=dict(arm=pd_joint_vel),
        )

    def _after_init(self):
        self.tip_links = [self.robot.links_map[n] for n in TIP_LINK_NAMES]

    @property
    def tip_poses(self):
        """Tip poses stacked on the last axis: (B, 7, 3 fingers)."""
        return torch.stack([link.pose.raw_pose for link in self.tip_links], -1)

    @property
    def tcp_pose(self):
        return self.tip_links[0].pose

    def is_grasping(self, object=None, min_force=0.5, max_angle=85):
        """At least two finger tips pressing the object."""
        pressing = sum(
            (torch.linalg.vector_norm(self.scene.get_pairwise_contact_forces(link, object), dim=-1) >= min_force)
            .to(torch.int32)
            for link in self.tip_links
        )
        return pressing >= 2

    def is_static(self, threshold: float = 0.2):
        return torch.amax(torch.abs(self.robot.qvel), 1) <= threshold
