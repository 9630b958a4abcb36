"""ANYmal C quadruped (counterpart of
maniskill_tpu/agents/robots/anymal/anymal_c.py).

Loaded from the port's copy of the compact URDF (public
anymal_c_simple_description frames, primitive collisions). Joint and
keyframe order is the URDF loader's depth-first link order, leg by leg (LF,
LH, RF, RH).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .... import PACKAGE_ASSET_DIR
from ...base_agent import BaseAgent, Keyframe
from ...controllers import PDJointPosControllerConfig
from ...registration import register_agent

JOINT_NAMES = [f"{leg}_{j}" for leg in ["LF", "LH", "RF", "RH"] for j in ["HAA", "HFE", "KFE"]]


@register_agent()
class ANYmalC(BaseAgent):
    uid = "anymal_c"
    urdf_path = os.path.join(PACKAGE_ASSET_DIR, "robots", "anymal_c", "anymal_c.urdf")
    fix_root_link = False
    disable_self_collisions = True

    keyframes = dict(
        standing=Keyframe(
            pose=np.array([0, 0, 0.545, 1, 0, 0, 0]),
            # per leg (HAA, HFE, KFE): LF, LH, RF, RH
            qpos=np.array([0.03, 0.4, -0.8, 0.03, -0.4, 0.8, -0.03, 0.4, -0.8, -0.03, -0.4, 0.8]),
        )
    )

    # zero delta actions re-anchor the targets to the current qpos every
    # control step, so the robot sags without a policy, as upstream does
    stiffness = 80.0
    damping = 2.0
    force_limit = 100.0

    @property
    def _controller_configs(self):
        pd_joint_delta_pos = PDJointPosControllerConfig(
            joint_names=JOINT_NAMES, lower=-0.225, upper=0.225, stiffness=self.stiffness,
            damping=self.damping, force_limit=self.force_limit, normalize_action=True, use_delta=True,
        )
        pd_joint_pos = PDJointPosControllerConfig(
            joint_names=JOINT_NAMES, lower=None, upper=None, stiffness=self.stiffness,
            damping=self.damping, force_limit=self.force_limit, normalize_action=False,
        )
        return dict(
            pd_joint_delta_pos=dict(body=pd_joint_delta_pos, balance_passive_force=False),
            pd_joint_pos=dict(body=pd_joint_pos, balance_passive_force=False),
        )

    def is_standing(self, ground_height=0.0):
        """Face up within ~20 degrees and the body at least 0.35 m up."""
        pose = self.robot.pose
        inner_prod = pose.q[:, 0]  # the dot product with the identity quaternion
        angle_diff = torch.arccos(torch.clamp(2 * inner_prod**2 - 1, -1.0, 1.0))
        return (angle_diff < 0.349) & (pose.p[:, 2] > 0.35 + ground_height)

    def is_fallen(self):
        """Fallen when the main body touches the ground."""
        forces = self.robot.get_net_contact_forces(["base"])
        return torch.linalg.vector_norm(forces, dim=-1).amax(-1) > 1.0
