"""FloatingPandaGripper (counterpart of
maniskill_tpu/agents/robots/floating_panda_gripper/floating_panda_gripper.py):
a Panda hand floating on a 6-dof chain of virtual joints (3 SLIDE, 3
HINGE), for tasks that need a gripper without arm kinematics."""
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
GRIPPER_JOINTS = ["panda_finger_joint1", "panda_finger_joint2"]


@register_agent()
class FloatingPandaGripper(BaseAgent):
    uid = "floating_panda_gripper"
    fix_root_link = True
    disable_self_collisions = True

    keyframes = dict(rest=Keyframe(qpos=np.array([0, 0, 0.3, 0, np.pi, 0, 0.04, 0.04]),
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

        b.add_link(LinkSpec("panda_hand", prev, joint_type=FIXED, joint_name="hand_mount", mass=0.73,
                            com=(-0.01, 0, 0.03), inertia=np.array([0.001, 0.0025, 0.0017]),
                            collisions=[box((0.0315, 0.1, 0.0334), (0, 0, 0.033))],
                            visuals=[box((0.0315, 0.1, 0.0334), (0, 0, 0.033))]))
        b.add_link(LinkSpec("panda_hand_tcp", "panda_hand", joint_type=FIXED, joint_name="panda_hand_tcp_joint",
                            origin_pos=(0, 0, 0.1034), mass=1e-4, inertia=np.full(3, 1e-8)))
        for name, sgn in (("panda_leftfinger", 1.0), ("panda_rightfinger", -1.0)):
            b.add_link(LinkSpec(
                name, "panda_hand", SLIDE, "panda_finger_joint1" if sgn > 0 else "panda_finger_joint2",
                origin_pos=(0, 0, 0.0584), axis=(0, sgn, 0), limit=(0.0, 0.04), armature=0.05, mass=0.015,
                com=(0, sgn * 0.005, 0.03), inertia=np.array([2.375e-06, 2.375e-06, 7.5e-07]),
                collisions=[box((0.011, 0.0075, 0.028), (0, sgn * 0.0075, 0.026), 2.0)],
                visuals=[box((0.011, 0.0075, 0.028), (0, sgn * 0.0075, 0.026))],
            ))
        return b

    @property
    def _controller_configs(self):
        root = PDJointPosControllerConfig(joint_names=ROOT_JOINTS, lower=-0.1, upper=0.1, stiffness=1e3,
                                          damping=1e2, force_limit=100, use_delta=True)
        gripper = PDJointPosMimicControllerConfig(joint_names=GRIPPER_JOINTS, lower=-0.01, upper=0.04,
                                                  stiffness=1e3, damping=1e2, force_limit=100)
        return dict(pd_joint_delta_pos=dict(root=root, gripper=gripper))

    def _after_init(self):
        self.tcp = self.robot.links_map["panda_hand_tcp"]
        self.finger1_link = self.robot.links_map["panda_leftfinger"]
        self.finger2_link = self.robot.links_map["panda_rightfinger"]
        # the fingers' closing directions in their own frames, on the device once
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
