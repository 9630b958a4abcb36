"""Franka Emika Panda agent (counterpart of
maniskill_tpu/agents/robots/panda/panda.py).

Kinematics and inertial constants are the public Franka values; collision
shapes are primitives (capsules for the arm links, boxes for the hand and
fingers). All eight control modes of the reference's Panda are here: joint
position (absolute, delta, target delta), joint velocity, and end-effector
position or pose deltas (current or target based) through batched IK.
"""
from __future__ import annotations

import numpy as np
import torch

from ....building.articulation_builder import ArticulationBuilder, LinkSpec, ShapeSpec
from ....physics.types import BOX, CAPSULE, HINGE, SLIDE
from ....utils import common
from ....utils.geometry.rotation_conversions import quaternion_apply
from ...base_agent import BaseAgent, Keyframe
from ...controllers import (
    PDEEPosControllerConfig,
    PDEEPoseControllerConfig,
    PDJointPosControllerConfig,
    PDJointPosMimicControllerConfig,
    PDJointVelControllerConfig,
)
from ...registration import register_agent


def _rpy(r, p, y):
    """URDF rpy -> wxyz quat (static xyz convention, R = Rz(y) Ry(p) Rx(r))."""
    cr, sr = np.cos(r / 2), np.sin(r / 2)
    cp, sp = np.cos(p / 2), np.sin(p / 2)
    cy, sy = np.cos(y / 2), np.sin(y / 2)
    return np.array(
        [
            cy * cp * cr + sy * sp * sr,
            cy * cp * sr - sy * sp * cr,
            cy * sp * cr + sy * cp * sr,
            sy * cp * cr - cy * sp * sr,
        ]
    )


def _I(ixx, iyy, izz, ixy, ixz, iyz):
    return np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])


ARM_JOINT_NAMES = [f"panda_joint{i}" for i in range(1, 8)]
GRIPPER_JOINT_NAMES = ["panda_finger_joint1", "panda_finger_joint2"]


def _cap(r, hl, pos=(0, 0, 0), quat=(1, 0, 0, 0)):
    return ShapeSpec(CAPSULE, [r, hl, 0], pos, quat, friction=1.0)


def _box(hs, pos=(0, 0, 0), quat=(1, 0, 0, 0), fric=1.0):
    return ShapeSpec(BOX, hs, pos, quat, friction=fric)


@register_agent()
class Panda(BaseAgent):
    uid = "panda"
    fix_root_link = True
    disable_self_collisions = True

    keyframes = dict(
        rest=Keyframe(
            qpos=np.array(
                [0.0, np.pi / 8, 0, -np.pi * 5 / 8, 0, np.pi * 3 / 4, np.pi / 4, 0.04, 0.04]
            ),
            pose=np.array([0, 0, 0, 1, 0, 0, 0]),
        )
    )

    arm_stiffness = 1e3
    arm_damping = 1e2
    arm_force_limit = 100
    gripper_stiffness = 1e3
    gripper_damping = 1e2
    gripper_force_limit = 100

    def _arm_link_specs(self):
        """The 7-dof arm + hand + tcp chain."""
        return [
            LinkSpec(
                "panda_link0", None, mass=0.629769,
                com=(-0.041018, -0.00014, 0.049974),
                inertia=_I(0.00315, 0.00388, 0.004285, 8.29e-07, 0.00015, 8.23e-06),
                collisions=[_cap(0.06, 0.03, (-0.02, 0, 0.05))],
                visuals=[_cap(0.06, 0.03, (-0.02, 0, 0.05))],
            ),
            LinkSpec(
                "panda_link1", "panda_link0", HINGE, "panda_joint1",
                origin_pos=(0, 0, 0.333), axis=(0, 0, 1),
                limit=(-2.8973, 2.8973), damping=0.0, armature=0.1,
                mass=4.970684, com=(0.003875, 0.002081, -0.04762),
                inertia=_I(0.70337, 0.70661, 0.009117, -0.000139, 0.006772, 0.019169),
                collisions=[_cap(0.06, 0.13, (0, 0, -0.08))],
                visuals=[_cap(0.06, 0.13, (0, 0, -0.08))],
            ),
            LinkSpec(
                "panda_link2", "panda_link1", HINGE, "panda_joint2",
                origin_quat=_rpy(-np.pi / 2, 0, 0), axis=(0, 0, 1),
                limit=(-1.7628, 1.7628), armature=0.1,
                mass=0.646926, com=(-0.003141, -0.02872, 0.003495),
                inertia=_I(0.007962, 0.02811, 0.025995, -0.003925, 0.010254, 0.000704),
                collisions=[_cap(0.06, 0.07, (0, -0.07, 0), _rpy(np.pi / 2, 0, 0))],
                visuals=[_cap(0.06, 0.07, (0, -0.07, 0), _rpy(np.pi / 2, 0, 0))],
            ),
            LinkSpec(
                "panda_link3", "panda_link2", HINGE, "panda_joint3",
                origin_pos=(0, -0.316, 0), origin_quat=_rpy(np.pi / 2, 0, 0),
                axis=(0, 0, 1), limit=(-2.8973, 2.8973), armature=0.1,
                mass=3.228604, com=(0.027518, 0.039252, -0.066502),
                inertia=_I(0.037242, 0.036155, 0.01083, -0.004761, -0.011396, -0.012805),
                collisions=[_cap(0.055, 0.065, (0.04, 0.02, -0.03))],
                visuals=[_cap(0.055, 0.065, (0.04, 0.02, -0.03))],
            ),
            LinkSpec(
                "panda_link4", "panda_link3", HINGE, "panda_joint4",
                origin_pos=(0.0825, 0, 0), origin_quat=_rpy(np.pi / 2, 0, 0),
                axis=(0, 0, 1), limit=(-3.0718, -0.0698), armature=0.1,
                mass=3.587895, com=(-0.05317, 0.104419, 0.027454),
                inertia=_I(0.025853, 0.019552, 0.028323, 0.007796, -0.001332, 0.008641),
                collisions=[_cap(0.055, 0.065, (-0.04, 0.05, 0.02))],
                visuals=[_cap(0.055, 0.065, (-0.04, 0.05, 0.02))],
            ),
            LinkSpec(
                "panda_link5", "panda_link4", HINGE, "panda_joint5",
                origin_pos=(-0.0825, 0.384, 0), origin_quat=_rpy(-np.pi / 2, 0, 0),
                axis=(0, 0, 1), limit=(-2.8973, 2.8973), armature=0.1,
                mass=1.225946, com=(-0.011953, 0.041065, -0.038437),
                inertia=_I(0.035549, 0.029474, 0.008627, -0.002117, -0.004037, 0.000229),
                collisions=[_cap(0.05, 0.11, (0, 0.03, -0.11))],
                visuals=[_cap(0.05, 0.11, (0, 0.03, -0.11))],
            ),
            LinkSpec(
                "panda_link6", "panda_link5", HINGE, "panda_joint6",
                origin_quat=_rpy(np.pi / 2, 0, 0), axis=(0, 0, 1),
                limit=(-0.0175, 3.7525), armature=0.1,
                mass=1.666555, com=(0.060149, -0.014117, -0.010517),
                inertia=_I(0.001964, 0.004354, 0.005433, 0.000109, -0.001158, 0.000341),
                collisions=[_cap(0.05, 0.03, (0.05, 0.0, 0.0), _rpy(0, np.pi / 2, 0))],
                visuals=[_cap(0.05, 0.03, (0.05, 0.0, 0.0), _rpy(0, np.pi / 2, 0))],
            ),
            LinkSpec(
                "panda_link7", "panda_link6", HINGE, "panda_joint7",
                origin_pos=(0.088, 0, 0), origin_quat=_rpy(np.pi / 2, 0, 0),
                axis=(0, 0, 1), limit=(-2.8973, 2.8973), armature=0.1,
                mass=0.735522, com=(0.010517, -0.004252, 0.061597),
                inertia=_I(0.012516, 0.010027, 0.004815, -0.000428, -0.001196, -0.000741),
                collisions=[_cap(0.045, 0.02, (0, 0, 0.055))],
                visuals=[_cap(0.045, 0.02, (0, 0, 0.055))],
            ),
            # fixed chain: link7 -> hand (rotated -45deg) -> tcp frame
            LinkSpec(
                "panda_hand", "panda_link7", joint_type=3, joint_name="panda_hand_joint",
                origin_pos=(0, 0, 0.107), origin_quat=_rpy(0, 0, -np.pi / 4),
                mass=0.73, com=(-0.01, 0, 0.03),
                inertia=_I(0.001, 0.0025, 0.0017, 0, 0, 0),
                collisions=[_box((0.0315, 0.1, 0.0334), (0, 0, 0.033))],
                visuals=[_box((0.0315, 0.1, 0.0334), (0, 0, 0.033))],
            ),
            LinkSpec(
                "panda_hand_tcp", "panda_hand", joint_type=3,
                joint_name="panda_hand_tcp_joint", origin_pos=(0, 0, 0.1034),
                mass=1e-4, inertia=np.full(3, 1e-8),
            ),
        ]

    def build_description(self) -> ArticulationBuilder:
        b = ArticulationBuilder(self.scene)
        links = self._arm_link_specs() + [
            LinkSpec(
                "panda_leftfinger", "panda_hand", SLIDE, "panda_finger_joint1",
                origin_pos=(0, 0, 0.0584), axis=(0, 1, 0), limit=(0.0, 0.04),
                damping=0.0, armature=0.05,
                mass=0.015, com=(0, 0.005, 0.03),
                inertia=np.array([2.375e-06, 2.375e-06, 7.5e-07]),
                collisions=[_box((0.011, 0.0075, 0.028), (0, 0.0075, 0.026), fric=2.0)],
                visuals=[_box((0.011, 0.0075, 0.028), (0, 0.0075, 0.026))],
            ),
            LinkSpec(
                "panda_rightfinger", "panda_hand", SLIDE, "panda_finger_joint2",
                origin_pos=(0, 0, 0.0584), axis=(0, -1, 0), limit=(0.0, 0.04),
                damping=0.0, armature=0.05,
                mass=0.015, com=(0, -0.005, 0.03),
                inertia=np.array([2.375e-06, 2.375e-06, 7.5e-07]),
                collisions=[_box((0.011, 0.0075, 0.028), (0, -0.0075, 0.026), fric=2.0)],
                visuals=[_box((0.011, 0.0075, 0.028), (0, -0.0075, 0.026))],
            ),
        ]
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
        arm_pd_joint_pos = PDJointPosControllerConfig(
            **arm_common, lower=None, upper=None, normalize_action=False
        )
        arm_pd_joint_delta_pos = PDJointPosControllerConfig(
            **arm_common, lower=-0.1, upper=0.1, use_delta=True
        )
        arm_pd_joint_target_delta_pos = PDJointPosControllerConfig(
            **arm_common, lower=-0.1, upper=0.1, use_delta=True, use_target=True
        )
        ee = dict(**arm_common, pos_lower=-0.1, pos_upper=0.1, ee_link="panda_hand_tcp", use_delta=True)
        arm_pd_ee_delta_pos = PDEEPosControllerConfig(**ee)
        arm_pd_ee_target_delta_pos = PDEEPosControllerConfig(**ee, use_target=True)
        arm_pd_ee_delta_pose = PDEEPoseControllerConfig(**ee, rot_lower=-0.1, rot_upper=0.1)
        arm_pd_ee_target_delta_pose = PDEEPoseControllerConfig(
            **ee, rot_lower=-0.1, rot_upper=0.1, use_target=True
        )
        arm_pd_joint_vel = PDJointVelControllerConfig(
            joint_names=ARM_JOINT_NAMES, lower=-1.0, upper=1.0,
            damping=self.arm_damping, force_limit=self.arm_force_limit,
        )
        gripper_pd_joint_pos = PDJointPosMimicControllerConfig(
            joint_names=GRIPPER_JOINT_NAMES,
            lower=-0.01, upper=0.04,
            stiffness=self.gripper_stiffness,
            damping=self.gripper_damping,
            force_limit=self.gripper_force_limit,
        )
        arms = dict(
            pd_joint_delta_pos=arm_pd_joint_delta_pos,
            pd_joint_pos=arm_pd_joint_pos,
            pd_joint_target_delta_pos=arm_pd_joint_target_delta_pos,
            pd_joint_vel=arm_pd_joint_vel,
            pd_ee_delta_pos=arm_pd_ee_delta_pos,
            pd_ee_delta_pose=arm_pd_ee_delta_pose,
            pd_ee_target_delta_pos=arm_pd_ee_target_delta_pos,
            pd_ee_target_delta_pose=arm_pd_ee_target_delta_pose,
        )
        return {mode: dict(arm=arm, gripper=gripper_pd_joint_pos) for mode, arm in arms.items()}

    def _after_init(self):
        self.tcp = self.robot.links_map["panda_hand_tcp"]
        self.finger1_link = self.robot.links_map["panda_leftfinger"]
        self.finger2_link = self.robot.links_map["panda_rightfinger"]
        # closing directions of the fingers in their link frames
        dev = self.scene.device
        self._close_dir1 = torch.tensor([0.0, -1.0, 0.0], device=dev)
        self._close_dir2 = torch.tensor([0.0, 1.0, 0.0], device=dev)

    @property
    def tcp_pose(self):
        return self.tcp.pose

    def is_grasping(self, object, min_force=0.5, max_angle=85.0):
        """Both fingers push on ``object`` with at least ``min_force`` N, each
        within ``max_angle`` degrees of its closing direction."""
        l_forces = self.scene.get_pairwise_contact_forces(self.finger1_link, object)
        r_forces = self.scene.get_pairwise_contact_forces(self.finger2_link, object)
        lforce = torch.linalg.vector_norm(l_forces, dim=-1)
        rforce = torch.linalg.vector_norm(r_forces, dim=-1)
        ldirection = quaternion_apply(self.finger1_link.pose.q, self._close_dir1)
        rdirection = quaternion_apply(self.finger2_link.pose.q, self._close_dir2)
        langle = common.compute_angle_between(ldirection, l_forces)
        rangle = common.compute_angle_between(rdirection, r_forces)
        lflag = (lforce >= min_force) & (torch.rad2deg(langle) <= max_angle)
        rflag = (rforce >= min_force) & (torch.rad2deg(rangle) <= max_angle)
        return lflag & rflag

    def is_static(self, threshold: float = 0.2):
        qvel = self.robot.qvel[..., :-2]  # the gripper is excluded
        return torch.amax(torch.abs(qvel), 1) <= threshold
