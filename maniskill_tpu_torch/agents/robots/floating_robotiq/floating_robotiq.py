"""Floating Robotiq 2F-85 gripper (counterpart of
maniskill_tpu/agents/robots/floating_robotiq/floating_robotiq.py): the
gripper on a 6-dof virtual joint chain, its pads two prismatic fingers (as
in the xArm6-Robotiq's gripper), built from ``LinkSpec``s."""
from __future__ import annotations

import numpy as np
import torch

from ....building.articulation_builder import ArticulationBuilder, LinkSpec, ShapeSpec
from ....physics.types import BOX, FIXED, HINGE, SLIDE
from ....utils import common
from ....utils.geometry.rotation_conversions import quaternion_apply
from ...base_agent import BaseAgent, Keyframe
from ...controllers import PDJointPosControllerConfig, PDJointPosMimicControllerConfig
from ...registration import register_agent

ROOT_JOINTS = ["root_x", "root_y", "root_z", "root_rx", "root_ry", "root_rz"]
GRIPPER_JOINTS = ["left_driver_joint", "right_driver_joint"]


@register_agent()
class FloatingRobotiq2F85Gripper(BaseAgent):
    uid = "floating_robotiq_2f_85_gripper"
    fix_root_link = True
    disable_self_collisions = True

    keyframes = dict(rest=Keyframe(qpos=np.array([0, 0, 0.3, 0, np.pi, 0, 0.0425, 0.0425]),
                                   pose=np.array([0, 0, 0, 1, 0, 0, 0])))

    def build_description(self):
        b = ArticulationBuilder(self.scene)
        tiny = dict(mass=1e-3, inertia=np.full(3, 1e-7))
        b.add_link(LinkSpec("root", None))
        axes = [(1, 0, 0), (0, 1, 0), (0, 0, 1)]
        prev = "root"
        for name, axis in zip(ROOT_JOINTS[:3], axes):
            b.add_link(LinkSpec(f"dummy_{name}", prev, SLIDE, name, axis=axis, limit=(-2.0, 2.0), damping=10.0,
                                armature=0.05, **tiny))
            prev = f"dummy_{name}"
        for name, axis in zip(ROOT_JOINTS[3:], axes):
            b.add_link(LinkSpec(f"dummy_{name}", prev, HINGE, name, axis=axis, limit=(-2 * np.pi, 2 * np.pi),
                                damping=2.0, armature=0.02, **tiny))
            prev = f"dummy_{name}"

        def box(hs, pos, fric=1.0):
            return ShapeSpec(BOX, hs, pos, friction=fric)

        b.add_link(LinkSpec("robotiq_base", prev, FIXED, "hand_mount", mass=0.7, com=(0, 0, 0.045),
                            inertia=np.array([0.001, 0.001, 0.0008]),
                            collisions=[box((0.04, 0.04, 0.045), (0, 0, 0.045))],
                            visuals=[box((0.04, 0.04, 0.045), (0, 0, 0.045))]))
        b.add_link(LinkSpec("grasp_convenient_link", "robotiq_base", FIXED, "tcp_joint", origin_pos=(0, 0, 0.15),
                            mass=1e-4, inertia=np.full(3, 1e-8)))
        for name, joint, sgn in (("left_pad", "left_driver_joint", 1.0), ("right_pad", "right_driver_joint", -1.0)):
            b.add_link(LinkSpec(
                name, "robotiq_base", SLIDE, joint, origin_pos=(0, -0.0425 * sgn, 0.09), axis=(0, sgn, 0),
                limit=(0.0, 0.0425), armature=0.05, mass=0.04, com=(0, sgn * 0.004, 0.03),
                inertia=np.array([5e-06, 5e-06, 2e-06]),
                collisions=[box((0.012, 0.007, 0.028), (0, sgn * 0.007, 0.028), 2.0)],
                visuals=[box((0.012, 0.007, 0.028), (0, sgn * 0.007, 0.028))],
            ))
        return b

    @property
    def _controller_configs(self):
        root = PDJointPosControllerConfig(joint_names=ROOT_JOINTS, lower=-0.1, upper=0.1, stiffness=1e3, damping=1e2,
                                          force_limit=100, use_delta=True)
        gripper = PDJointPosMimicControllerConfig(joint_names=GRIPPER_JOINTS, lower=0.0, upper=0.0425, stiffness=1e3,
                                                  damping=1e2, force_limit=60)
        return dict(pd_joint_delta_pos=dict(root=root, gripper=gripper))

    def _after_init(self):
        self.tcp = self.robot.links_map["grasp_convenient_link"]
        self.finger1_link = self.robot.links_map["left_pad"]
        self.finger2_link = self.robot.links_map["right_pad"]
        self._close_dir1 = torch.tensor([0.0, -1.0, 0.0], device=self.scene.device)
        self._close_dir2 = torch.tensor([0.0, 1.0, 0.0], device=self.scene.device)

    @property
    def tcp_pose(self):
        return self.tcp.pose

    def is_grasping(self, object, min_force=0.5, max_angle=85.0):
        l_forces = self.scene.get_pairwise_contact_forces(self.finger1_link, object)
        r_forces = self.scene.get_pairwise_contact_forces(self.finger2_link, object)
        lforce = torch.linalg.vector_norm(l_forces, dim=-1)
        rforce = torch.linalg.vector_norm(r_forces, dim=-1)
        langle = common.compute_angle_between(quaternion_apply(self.finger1_link.pose.q, self._close_dir1), l_forces)
        rangle = common.compute_angle_between(quaternion_apply(self.finger2_link.pose.q, self._close_dir2), r_forces)
        return ((lforce >= min_force) & (torch.rad2deg(langle) <= max_angle)
                & (rforce >= min_force) & (torch.rad2deg(rangle) <= max_angle))

    def is_static(self, threshold: float = 0.2):
        return torch.amax(torch.abs(self.robot.qvel[..., :-2]), 1) <= threshold
