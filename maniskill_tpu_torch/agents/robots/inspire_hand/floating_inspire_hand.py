"""Floating Inspire RH56DFX-2LR hands (counterpart of
maniskill_tpu/agents/robots/inspire_hand/floating_inspire_hand.py).

20 dof: 6 virtual root joints, 2 wrist joints, 6 active finger joints and 6
underactuated PIP/IP joints driven passively. Loaded from the port's copies
of the compact URDFs.
"""
from __future__ import annotations

import os
from dataclasses import replace

import numpy as np

from .... import PACKAGE_ASSET_DIR
from ...base_agent import BaseAgent, Keyframe
from ...controllers import PassiveControllerConfig, PDJointPosControllerConfig
from ...registration import register_agent

URDF_DIR = os.path.join(PACKAGE_ASSET_DIR, "robots", "inspire_hand")

ROOT_JOINT_NAMES = [f"root_{a}_{kind}_joint" for kind in ("axis", "rot") for a in "xyz"]

# the keyframes' rest values: the active joints at 0, the underactuated
# PIP/IP joints slightly flexed
PIP_REST = [-0.16734816, -0.16734803, -0.16734798, -0.167348]
THUMB_REST = [-0.08147363, -0.07234851]


def hand_joint_names(side: str):
    """(wrist, active, passive) joint names of one side."""
    p = f"{side}_hand_"
    wrist = [p + "wrist_pitch_joint", p + "wrist_yaw_joint"]
    active = [p + j for j in ("thumb_CMC_yaw_joint", "thumb_CMC_pitch_joint", "index_MCP_joint",
                              "middle_MCP_joint", "ring_MCP_joint", "pinky_MCP_joint")]
    passive = [p + j for j in ("thumb_MCP_joint", "thumb_IP_joint", "index_PIP_joint", "middle_PIP_joint",
                               "ring_PIP_joint", "pinky_PIP_joint")]
    return wrist, active, passive


def hand_keyframes(side_sign: float, n_root: int):
    """palm_side and palm_up; the qpos is the root's ``n_root`` joints, the
    wrist, the thumb chain and each finger's chain (the URDF's depth-first
    order)."""
    qpos = np.array([0.0] * (n_root + 2) + [0.0, 0.0] + THUMB_REST + sum(([0.0, r] for r in PIP_REST), []))
    return dict(
        palm_side=Keyframe(pose=np.array([0, 0, 0.4, np.cos(-np.pi / 4), 0, 0, np.sin(-np.pi / 4)]), qpos=qpos),
        palm_up=Keyframe(pose=np.array([0, 0, 0.4, 0.5, side_sign * 0.5, -side_sign * 0.5, 0.5]), qpos=qpos),
    )


class _FloatingInspireHand(BaseAgent):
    side: str = "right"
    fix_root_link = True
    disable_self_collisions = True
    root_joint_names = ROOT_JOINT_NAMES

    @property
    def tip_link_names(self):
        return [f"{self.side}_hand_{f}_tip" for f in ("thumb", "index", "middle", "ring", "pinky")]

    @property
    def _controller_configs(self):
        wrist, active, passive = hand_joint_names(self.side)
        pd = dict(lower=None, upper=None, stiffness=1e3, damping=1e2, normalize_action=False)
        parts = dict(
            root=PDJointPosControllerConfig(joint_names=self.root_joint_names, force_limit=100, **pd),
            wrist=PDJointPosControllerConfig(joint_names=wrist, force_limit=100, **pd),
            fingers=PDJointPosControllerConfig(joint_names=active, force_limit=20, **pd),
        )
        if not self.root_joint_names:
            del parts["root"]
        passive_cfg = PassiveControllerConfig(joint_names=passive, damping=0.001, force_limit=20)
        delta = dict(use_delta=True, normalize_action=True, lower=-0.1, upper=0.1)
        return dict(
            pd_joint_pos=dict(**parts, passive=passive_cfg),
            pd_joint_delta_pos=dict(**{k: replace(c, **delta) for k, c in parts.items()}, passive=passive_cfg),
        )


@register_agent()
class FloatingInspireHandRight(_FloatingInspireHand):
    uid = "floating_inspire_hand_right"
    side = "right"
    urdf_path = os.path.join(URDF_DIR, "inspire_hand_right_floating.urdf")
    keyframes = hand_keyframes(1.0, 6)


@register_agent()
class FloatingInspireHandLeft(_FloatingInspireHand):
    uid = "floating_inspire_hand_left"
    side = "left"
    urdf_path = os.path.join(URDF_DIR, "inspire_hand_left_floating.urdf")
    keyframes = hand_keyframes(-1.0, 6)
