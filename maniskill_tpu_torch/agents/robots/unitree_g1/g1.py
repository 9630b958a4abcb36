"""Unitree G1 humanoid, simplified-legs variant (counterpart of
maniskill_tpu/agents/robots/unitree_g1/g1.py).

Loaded from the port's copy of the compact URDF (public g1_description leg
frames, the arms folded into the torso body). 13 actuated dofs (two 6-dof
legs and the torso); keyframe qpos is depth-first: left leg (hip pitch,
roll, yaw, knee, ankle pitch, roll), right leg, torso.
"""
from __future__ import annotations

import os

import numpy as np

from .... import PACKAGE_ASSET_DIR
from ...base_agent import BaseAgent, Keyframe
from ...controllers import PDJointPosControllerConfig
from ...registration import register_agent

_LEG = ["hip_pitch", "hip_roll", "hip_yaw", "knee", "ankle_pitch", "ankle_roll"]
JOINT_NAMES = [f"left_{j}_joint" for j in _LEG] + [f"right_{j}_joint" for j in _LEG] + ["torso_joint"]

_LEG_Q = [-0.4, 0.0, 0.0, 0.8, -0.4, 0.0]


@register_agent()
class UnitreeG1Simplified(BaseAgent):
    uid = "unitree_g1_simplified_legs"
    urdf_path = os.path.join(PACKAGE_ASSET_DIR, "robots", "unitree_g1", "g1_simplified.urdf")
    fix_root_link = False
    disable_self_collisions = True

    keyframes = dict(
        standing=Keyframe(pose=np.array([0, 0, 0.755, 1, 0, 0, 0]), qpos=np.array(_LEG_Q + _LEG_Q + [0.0]))
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
        z = self.robot.pose.p[:, 2]
        return (z > 0.5) & (z < 1.0)

    def is_fallen(self):
        return self.robot.pose.p[:, 2] < 0.3
