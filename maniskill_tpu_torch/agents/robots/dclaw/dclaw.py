"""DClaw (counterpart of maniskill_tpu/agents/robots/dclaw/dclaw.py): the
9-dof D'Claw tri-finger hand built from ``LinkSpec``s, three 3-link
capsule fingers at 120 degrees hanging from a base plate."""
from __future__ import annotations

import numpy as np
import torch

from ....building.articulation_builder import ArticulationBuilder, LinkSpec, ShapeSpec
from ....physics.types import BOX, CAPSULE, HINGE
from ...base_agent import BaseAgent, Keyframe
from ...controllers import PDJointPosControllerConfig
from ...registration import register_agent


def _rotz(a):
    return np.array([np.cos(a / 2), 0, 0, np.sin(a / 2)])


JOINT_NAMES = [f"joint_f{f}_{j}" for f in range(3) for j in range(3)]


@register_agent()
class DClaw(BaseAgent):
    uid = "dclaw"
    fix_root_link = True
    disable_self_collisions = True

    keyframes = dict(rest=Keyframe(qpos=np.array([0.0, -0.8, -1.0] * 3), pose=np.array([0, 0, 0.30, 1, 0, 0, 0])))

    def build_description(self):
        b = ArticulationBuilder(self.scene)
        plate = ShapeSpec(BOX, (0.06, 0.06, 0.01), friction=1.0, color=(0.2, 0.2, 0.2, 1))
        b.add_link(LinkSpec("base", None, collisions=[plate], visuals=[plate]))
        L1, L2, L3 = 0.05, 0.06, 0.06
        r = 0.012

        def cap(L):
            return ShapeSpec(CAPSULE, [r, L / 2, 0], (0, 0, -L / 2), friction=2.0, color=(0.9, 0.4, 0.1, 1))

        for f in range(3):
            ang = 2 * np.pi * f / 3
            mount = (0.05 * np.cos(ang), 0.05 * np.sin(ang), -0.01)
            # joint 0 twists about the vertical, joints 1 and 2 flex
            b.add_link(LinkSpec(f"f{f}_prox", "base", HINGE, f"joint_f{f}_0", origin_pos=mount,
                                origin_quat=_rotz(ang), axis=(0, 0, 1), limit=(-0.6, 0.6), damping=0.1,
                                armature=0.01, collisions=[cap(L1)], visuals=[cap(L1)]))
            b.add_link(LinkSpec(f"f{f}_mid", f"f{f}_prox", HINGE, f"joint_f{f}_1", origin_pos=(0, 0, -L1),
                                axis=(0, 1, 0), limit=(-2.0, 2.0), damping=0.1, armature=0.01,
                                collisions=[cap(L2)], visuals=[cap(L2)]))
            b.add_link(LinkSpec(f"f{f}_dist", f"f{f}_mid", HINGE, f"joint_f{f}_2", origin_pos=(0, 0, -L2),
                                axis=(0, 1, 0), limit=(-2.0, 2.0), damping=0.1, armature=0.01,
                                collisions=[cap(L3)], visuals=[cap(L3)]))
        return b

    @property
    def _controller_configs(self):
        pd = PDJointPosControllerConfig(joint_names=JOINT_NAMES, lower=-0.3, upper=0.3, stiffness=50.0, damping=2.0,
                                        force_limit=20.0, use_delta=True)
        pd_abs = PDJointPosControllerConfig(joint_names=JOINT_NAMES, lower=None, upper=None, stiffness=50.0,
                                            damping=2.0, force_limit=20.0, normalize_action=False)
        return dict(pd_joint_delta_pos=dict(hand=pd), pd_joint_pos=dict(hand=pd_abs))

    def is_static(self, threshold: float = 0.2):
        return torch.amax(torch.abs(self.robot.qvel), 1) <= threshold
