"""Fixed-base Inspire hands (counterpart of
maniskill_tpu/agents/robots/inspire_hand/fixed_inspire_hand.py): the
floating hands without the 6-dof virtual root (14 dof)."""
from __future__ import annotations

import os

from ...registration import register_agent
from .floating_inspire_hand import URDF_DIR, _FloatingInspireHand, hand_keyframes


class _FixedInspireHand(_FloatingInspireHand):
    root_joint_names = []


@register_agent()
class FixedInspireHandRight(_FixedInspireHand):
    uid = "fixed_inspire_hand_right"
    side = "right"
    urdf_path = os.path.join(URDF_DIR, "inspire_hand_right.urdf")
    keyframes = hand_keyframes(1.0, 0)


@register_agent()
class FixedInspireHandLeft(_FixedInspireHand):
    uid = "fixed_inspire_hand_left"
    side = "left"
    urdf_path = os.path.join(URDF_DIR, "inspire_hand_left.urdf")
    keyframes = hand_keyframes(-1.0, 0)
