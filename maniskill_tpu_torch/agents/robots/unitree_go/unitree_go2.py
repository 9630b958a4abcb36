"""Unitree Go2 quadruped (counterpart of
maniskill_tpu/agents/robots/unitree_go/unitree_go2.py).

Loaded from the port's copy of the compact URDF (public go2_description
frames, primitive collisions). Keyframe qpos is leg by leg (FL, FR, RL, RR)
in the URDF loader's depth-first link order.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .... import PACKAGE_ASSET_DIR
from ...base_agent import BaseAgent, Keyframe
from ...controllers import PDJointPosControllerConfig
from ...registration import register_agent

JOINT_NAMES = [f"{leg}_{j}_joint" for leg in ["FL", "FR", "RL", "RR"] for j in ["hip", "thigh", "calf"]]


@register_agent()
class UnitreeGo2(BaseAgent):
    uid = "unitree_go2"
    urdf_path = os.path.join(PACKAGE_ASSET_DIR, "robots", "unitree_go2", "go2_description.urdf")
    fix_root_link = False
    disable_self_collisions = True

    keyframes = dict(
        standing=Keyframe(pose=np.array([0, 0, 0.29, 1, 0, 0, 0]), qpos=np.array([0.0, 0.9, -1.8] * 4))
    )

    @property
    def _controller_configs(self):
        pd_joint_delta_pos = PDJointPosControllerConfig(
            joint_names=JOINT_NAMES, lower=-0.7, upper=0.7, stiffness=1000.0, damping=100.0,
            normalize_action=True, use_delta=True,
        )
        pd_joint_pos = PDJointPosControllerConfig(
            joint_names=JOINT_NAMES, lower=None, upper=None, stiffness=1000.0, damping=100.0,
            normalize_action=False,
        )
        return dict(
            pd_joint_delta_pos=dict(body=pd_joint_delta_pos, balance_passive_force=False),
            pd_joint_pos=dict(body=pd_joint_pos, balance_passive_force=False),
        )

    def is_fallen(self):
        forces = self.robot.get_net_contact_forces(["base"])
        return torch.linalg.vector_norm(forces, dim=-1).amax(-1) > 1.0


@register_agent()
class UnitreeGo2Simplified(UnitreeGo2):
    """The simplified-collision uid (this URDF's collisions are primitives
    already)."""

    uid = "unitree_go2_simplified_locomotion"
