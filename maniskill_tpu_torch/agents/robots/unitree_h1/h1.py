"""Unitree H1 humanoid (counterpart of
maniskill_tpu/agents/robots/unitree_h1/h1.py: UnitreeH1, UnitreeH1Simplified
and UnitreeH1WithHandsUpperBodyOnly).

Loaded from the port's copy of the compact URDF (public h1_description
frames, primitive collisions). 19 actuated dofs; keyframe qpos is in the
URDF loader's depth-first link order: left leg (hip yaw, roll, pitch, knee,
ankle), right leg, torso, left arm (shoulder pitch, roll, yaw, elbow), right
arm.
"""
from __future__ import annotations

import os

import numpy as np

from .... import PACKAGE_ASSET_DIR
from ...base_agent import BaseAgent, Keyframe
from ...controllers import PassiveControllerConfig, PDJointPosControllerConfig
from ...registration import register_agent

_LEG = ["hip_yaw", "hip_roll", "hip_pitch", "knee", "ankle"]
_ARM = ["shoulder_pitch", "shoulder_roll", "shoulder_yaw", "elbow"]
JOINT_NAMES = (
    [f"left_{j}_joint" for j in _LEG]
    + [f"right_{j}_joint" for j in _LEG]
    + ["torso_joint"]
    + [f"left_{j}_joint" for j in _ARM]
    + [f"right_{j}_joint" for j in _ARM]
)

_LEG_Q = [0.0, 0.0, -0.4, 0.8, -0.4]


@register_agent()
class UnitreeH1(BaseAgent):
    uid = "unitree_h1"
    urdf_path = os.path.join(PACKAGE_ASSET_DIR, "robots", "unitree_h1", "h1.urdf")
    fix_root_link = False
    disable_self_collisions = True

    keyframes = dict(
        standing=Keyframe(pose=np.array([0, 0, 0.975, 1, 0, 0, 0]), qpos=np.array(_LEG_Q + _LEG_Q + [0.0] * 9))
    )

    body_stiffness = 1e3
    body_damping = 1e2
    body_force_limit = 100.0

    @property
    def _controller_configs(self):
        pd_joint_pos = PDJointPosControllerConfig(
            joint_names=JOINT_NAMES, lower=None, upper=None, stiffness=self.body_stiffness,
            damping=self.body_damping, force_limit=self.body_force_limit, normalize_action=False,
        )
        pd_joint_delta_pos = PDJointPosControllerConfig(
            joint_names=JOINT_NAMES, lower=-0.2, upper=0.2, stiffness=self.body_stiffness,
            damping=self.body_damping, force_limit=self.body_force_limit, use_delta=True,
        )
        return dict(
            pd_joint_pos=dict(body=pd_joint_pos, balance_passive_force=False),
            pd_joint_delta_pos=dict(body=pd_joint_delta_pos, balance_passive_force=False),
        )

    def is_standing(self):
        """The torso (root) height within the standing band."""
        z = self.robot.pose.p[:, 2]
        return (z > 0.8) & (z < 1.2)

    def is_fallen(self):
        return self.robot.pose.p[:, 2] < 0.3


@register_agent()
class UnitreeH1Simplified(UnitreeH1):
    """The collision-simplified uid (this URDF's collisions are primitives
    already)."""

    uid = "unitree_h1_simplified"


@register_agent()
class UnitreeH1WithHandsUpperBodyOnly(UnitreeH1):
    """H1 with wrist rolls and an actuated right-hand thumb chain: the 8
    shoulder and elbow joints and the 6 wrist and thumb joints run under PD,
    the 11 leg and torso joints run passive."""

    uid = "unitree_h1_with_hands_upper_body_only"
    urdf_path = os.path.join(PACKAGE_ASSET_DIR, "robots", "unitree_h1", "h1_with_hand.urdf")

    body_joints = [
        "left_shoulder_pitch_joint", "right_shoulder_pitch_joint",
        "left_shoulder_roll_joint", "right_shoulder_roll_joint",
        "left_shoulder_yaw_joint", "right_shoulder_yaw_joint",
        "left_elbow_joint", "right_elbow_joint",
    ]
    arm_hand_joints = [
        "left_hand_joint", "right_hand_joint",
        "R_thumb_proximal_yaw_joint", "R_thumb_proximal_pitch_joint",
        "R_thumb_intermediate_joint", "R_thumb_distal_joint",
    ]
    passive_joints = [
        "left_hip_yaw_joint", "left_hip_roll_joint", "left_hip_pitch_joint",
        "left_knee_joint", "left_ankle_joint",
        "right_hip_yaw_joint", "right_hip_roll_joint",
        "right_hip_pitch_joint", "right_knee_joint", "right_ankle_joint",
        "torso_joint",
    ]

    keyframes = dict(standing=Keyframe(pose=np.array([0, 0, 0.975, 1, 0, 0, 0]), qpos=np.zeros(25)))

    @property
    def _controller_configs(self):
        def pd(joints, **kw):
            return PDJointPosControllerConfig(
                joint_names=joints, stiffness=self.body_stiffness, damping=self.body_damping,
                force_limit=self.body_force_limit, **kw,
            )

        passive = PassiveControllerConfig(joint_names=self.passive_joints, damping=5.0, force_limit=200)
        absolute = dict(lower=None, upper=None, normalize_action=False)
        delta = dict(lower=-0.2, upper=0.2, use_delta=True)
        return dict(
            pd_joint_pos=dict(
                body=pd(self.body_joints, **absolute), arm_hands=pd(self.arm_hand_joints, **absolute),
                legs=passive, balance_passive_force=False,
            ),
            pd_joint_delta_pos=dict(
                body=pd(self.body_joints, **delta), arm_hands=pd(self.arm_hand_joints, **delta),
                legs=passive, balance_passive_force=False,
            ),
        )
