"""xArm7 with the PSYONIC Ability hand (counterpart of
maniskill_tpu/agents/robots/xarm/xarm7_ability.py, uid "xarm7_ability").

17 dof: 7 arm joints, the thumb (q1, q2) and four fingers whose q2 mimics
q1. Loaded from the port's copy of the combined URDF. ``pd_ee_delta_pose``
runs the batched IK on the arm with the hand's "base" link as its end.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .... import PACKAGE_ASSET_DIR
from ...base_agent import BaseAgent, Keyframe
from ...controllers import PDEEPoseControllerConfig, PDJointPosControllerConfig, PDJointPosMimicControllerConfig
from ...registration import register_agent
from ..floating_ability_hand.floating_ability_hand import FINGERS, MIMIC
from .xarm7 import ARM_JOINT_NAMES


@register_agent()
class XArm7Ability(BaseAgent):
    uid = "xarm7_ability"
    urdf_path = os.path.join(PACKAGE_ASSET_DIR, "robots", "xarm7", "xarm7_ability.urdf")
    fix_root_link = True
    disable_self_collisions = True

    keyframes = dict(rest=Keyframe(qpos=np.array([0, -0.4, 0, 0.5, 0, 0.9, -3.0] + [0.0] * 10),
                                   pose=np.array([0, 0, 0, 1, 0, 0, 0])))

    arm_stiffness = 1e3
    arm_damping = 1e2
    arm_force_limit = 500
    hand_stiffness = 1e3
    hand_damping = 1e2
    hand_force_limit = 50

    ee_link_name = "base"
    tip_link_names = [f"{f}_tip" for f in ["thumb"] + FINGERS]

    @property
    def _controller_configs(self):
        arm_common = dict(joint_names=ARM_JOINT_NAMES, stiffness=self.arm_stiffness, damping=self.arm_damping,
                          force_limit=self.arm_force_limit)
        arm_pd_joint_pos = PDJointPosControllerConfig(**arm_common, lower=None, upper=None, normalize_action=False)
        arm_pd_joint_delta_pos = PDJointPosControllerConfig(**arm_common, lower=-0.1, upper=0.1, use_delta=True)
        arm_pd_ee_delta_pose = PDEEPoseControllerConfig(
            **arm_common, pos_lower=-0.1, pos_upper=0.1, rot_lower=-0.1, rot_upper=0.1, ee_link=self.ee_link_name,
            use_delta=True,
        )
        hand = dict(lower=None, upper=None, stiffness=self.hand_stiffness, damping=self.hand_damping,
                    force_limit=self.hand_force_limit, normalize_action=False)
        hand_pd = PDJointPosMimicControllerConfig(
            joint_names=[f"{f}_q1" for f in FINGERS] + [f"{f}_q2" for f in FINGERS], mimic=MIMIC, **hand
        )
        thumb_pd = PDJointPosControllerConfig(joint_names=["thumb_q1", "thumb_q2"], **hand)
        return dict(
            pd_joint_pos=dict(arm=arm_pd_joint_pos, hand=hand_pd, thumb=thumb_pd),
            pd_joint_delta_pos=dict(arm=arm_pd_joint_delta_pos, hand=hand_pd, thumb=thumb_pd),
            pd_ee_delta_pose=dict(arm=arm_pd_ee_delta_pose, hand=hand_pd, thumb=thumb_pd),
        )

    def _after_init(self):
        self.tcp = self.robot.links_map[self.ee_link_name]
        self.tip_links = [self.robot.links_map[n] for n in self.tip_link_names]

    @property
    def tcp_pose(self):
        return self.tcp.pose

    def is_grasping(self, object, min_force=0.5):
        """The thumb tip and at least one opposing finger tip press the
        object with ``min_force`` N or more."""
        pressing = torch.stack([
            torch.linalg.vector_norm(self.scene.get_pairwise_contact_forces(link, object), dim=-1) >= min_force
            for link in self.tip_links
        ])
        return pressing[0] & pressing[1:].any(0)

    def is_static(self, threshold: float = 0.2):
        return torch.amax(torch.abs(self.robot.qvel[..., :7]), 1) <= threshold
