"""PandaStick (counterpart of maniskill_tpu/agents/robots/panda/panda_stick.py):
the Panda arm with a drawing stick in place of the gripper."""
from __future__ import annotations

import numpy as np
import torch

from ....building.articulation_builder import ArticulationBuilder, ShapeSpec
from ....physics.types import CAPSULE
from ...base_agent import Keyframe
from ...controllers import PDEEPosControllerConfig, PDJointPosControllerConfig
from ...registration import register_agent
from .panda import ARM_JOINT_NAMES, Panda


@register_agent()
class PandaStick(Panda):
    uid = "panda_stick"

    keyframes = dict(
        rest=Keyframe(
            qpos=np.array([0.0, np.pi / 8, 0, -np.pi * 5 / 8, 0, np.pi * 3 / 4, np.pi / 4]),
            pose=np.array([0, 0, 0, 1, 0, 0, 0]),
        )
    )

    def build_description(self) -> ArticulationBuilder:
        b = ArticulationBuilder(self.scene)
        links = self._arm_link_specs()
        # a slim stick below the hand whose collision surface ends exactly at
        # the TCP (panda_hand_tcp at +0.1034): the capsule's lower sphere
        # centre sits one radius above it, so the stick tip is the TCP
        tip_z = 0.1034
        r, hl = 0.008, 0.025
        stick = ShapeSpec(CAPSULE, [r, hl, 0], (0, 0, tip_z - hl - r), (1, 0, 0, 0))
        for spec in links:
            if spec.name == "panda_hand":
                spec.collisions = list(spec.collisions) + [stick]
                spec.visuals = list(spec.visuals) + [stick]
        for link in links:
            b.add_link(link)
        return b

    @property
    def _controller_configs(self):
        arm_common = dict(
            joint_names=ARM_JOINT_NAMES,
            stiffness=self.arm_stiffness,
            damping=self.arm_damping,
            force_limit=self.arm_force_limit,
        )
        return dict(
            pd_joint_delta_pos=dict(arm=PDJointPosControllerConfig(
                **arm_common, lower=-0.1, upper=0.1, use_delta=True)),
            pd_joint_pos=dict(arm=PDJointPosControllerConfig(
                **arm_common, lower=None, upper=None, normalize_action=False)),
            pd_ee_delta_pos=dict(arm=PDEEPosControllerConfig(
                **arm_common, pos_lower=-0.1, pos_upper=0.1,
                ee_link="panda_hand_tcp", use_delta=True)),
        )

    def _after_init(self):
        self.tcp = self.robot.links_map["panda_hand_tcp"]

    def is_grasping(self, object=None, min_force=0.5, max_angle=85):
        return torch.zeros(self.scene.num_envs, dtype=torch.bool, device=self.scene.device)

    def is_static(self, threshold: float = 0.2):
        return torch.amax(torch.abs(self.robot.qvel), 1) <= threshold
