"""Floating PSYONIC Ability hand (counterpart of
maniskill_tpu/agents/robots/floating_ability_hand/floating_ability_hand.py).

16 dof: 6 virtual root joints, the thumb (q1, q2) and four fingers whose q2
mimics q1 through the linkage, q2 = 1.05851325 q1 + 0.72349796. Loaded from
the port's copy of the compact URDF.
"""
from __future__ import annotations

import os

import numpy as np

from .... import PACKAGE_ASSET_DIR
from ...base_agent import BaseAgent, Keyframe
from ...controllers import PDJointPosControllerConfig, PDJointPosMimicControllerConfig
from ...registration import register_agent

ROOT_JOINT_NAMES = [f"root_{a}_{kind}_joint" for kind in ("axis", "rot") for a in "xyz"]
FINGERS = ["index", "middle", "ring", "pinky"]
MIMIC = {f"{f}_q2": dict(joint=f"{f}_q1", multiplier=1.05851325, offset=0.72349796) for f in FINGERS}


@register_agent()
class FloatingAbilityHandRight(BaseAgent):
    uid = "floating_ability_hand_right"
    urdf_path = os.path.join(PACKAGE_ASSET_DIR, "robots", "ability_hand", "ability_hand_right_floating.urdf")
    fix_root_link = True
    disable_self_collisions = True

    keyframes = dict(rest=Keyframe(qpos=np.zeros(16), pose=np.array([0, 0, 0, 1, 0, 0, 0])))

    hand_stiffness = 1e3
    hand_damping = 1e2
    hand_force_limit = 50

    tip_link_names = [f"{f}_tip" for f in ["thumb"] + FINGERS]
    palm_link_name = "thumb_base"

    @property
    def _controller_configs(self):
        float_pd = PDJointPosControllerConfig(joint_names=ROOT_JOINT_NAMES, lower=None, upper=None, stiffness=1e3,
                                              damping=1e2, force_limit=100, normalize_action=False)
        hand = dict(lower=None, upper=None, stiffness=self.hand_stiffness, damping=self.hand_damping,
                    force_limit=self.hand_force_limit, normalize_action=False)
        hand_pd = PDJointPosMimicControllerConfig(
            joint_names=[f"{f}_q1" for f in FINGERS] + [f"{f}_q2" for f in FINGERS], mimic=MIMIC, **hand
        )
        thumb_pd = PDJointPosControllerConfig(joint_names=["thumb_q1", "thumb_q2"], **hand)
        return dict(pd_joint_pos=dict(root=float_pd, hand=hand_pd, thumb=thumb_pd))
