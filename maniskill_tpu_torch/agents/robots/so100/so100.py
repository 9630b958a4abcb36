"""SO100 (LeRobot SO-ARM100) agent (counterpart of
maniskill_tpu/agents/robots/so100/so100.py): the arm built from
``LinkSpec``s (the public SO-ARM100 description's kinematic and inertial
constants, primitive collision shapes). ``so100_arm_links`` is the chain
that ``xlerobot`` mounts twice; ``_SO100Mixin`` holds the controllers and
the grasp and static checks."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ....building.articulation_builder import ArticulationBuilder, LinkSpec, ShapeSpec
from ....physics.types import BOX, CAPSULE, FIXED, HINGE
from ....utils import common
from ....utils.geometry.rotation_conversions import quaternion_apply
from ...base_agent import BaseAgent, Keyframe
from ...controllers import PDJointPosControllerConfig
from ...registration import register_agent


def _rpy(r, p, y):
    cr, sr = np.cos(r / 2), np.sin(r / 2)
    cp, sp = np.cos(p / 2), np.sin(p / 2)
    cy, sy = np.cos(y / 2), np.sin(y / 2)
    return np.array([
        cy * cp * cr + sy * sp * sr,
        cy * cp * sr - sy * sp * cr,
        cy * sp * cr + sy * cp * sr,
        sy * cp * cr - cy * sp * sr,
    ])


def _inertia(ixx, iyy, izz, ixy, ixz, iyz):
    return np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])


JOINT_NAMES = ["shoulder_pan", "shoulder_lift", "elbow_flex", "wrist_flex", "wrist_roll", "gripper"]


def so100_arm_links(prefix="", parent=None, origin_pos=(0, 0, 0), origin_quat=(1, 0, 0, 0), joint_names=None):
    """The SO-ARM100 chain as LinkSpecs; ``prefix``, ``parent`` (mounted by
    a fixed joint at ``origin_pos``/``origin_quat``) and ``joint_names``
    rename and re-root it, so that one robot can carry it twice."""

    def cap(r, hl, pos):
        return ShapeSpec(CAPSULE, [r, hl, 0], pos, (1, 0, 0, 0), friction=1.0)

    def box(hs, pos):
        return ShapeSpec(BOX, hs, pos, (1, 0, 0, 0), friction=2.0)

    def shapes(make, *args):
        return dict(collisions=[make(*args)], visuals=[make(*args)])

    links = [
        LinkSpec("Base", None, mass=0.1932, com=(-2.46e-07, 0.03114, 0.01757),
                 inertia=_inertia(1.3703e-4, 1.6909e-4, 1.451e-4, 2.1e-08, 4.2e-09, 2.265e-05),
                 **shapes(box, (0.04, 0.05, 0.025), (0, 0.03, 0.02))),
        LinkSpec("Rotation_Pitch", "Base", HINGE, "shoulder_pan", origin_pos=(0, -0.0452, 0.0165),
                 origin_quat=_rpy(1.5708, 0, 0), axis=(0, -1, 0), limit=(-2.0, 2.0), armature=0.02,
                 mass=0.1192, com=(-9.08e-05, 0.0591, 0.03109),
                 inertia=_inertia(5.904e-05, 3.215e-05, 5.861e-05, 4.9e-07, -5.9e-08, -4.58e-06),
                 **shapes(cap, 0.03, 0.03, (0, 0.06, 0.03))),
        LinkSpec("Upper_Arm", "Rotation_Pitch", HINGE, "shoulder_lift", origin_pos=(0, 0.1025, 0.0306),
                 axis=(1, 0, 0), limit=(-1.5708, 1.5708), armature=0.02, mass=0.1624, com=(-1.72e-05, 0.0702, 0.0031),
                 inertia=_inertia(1.6715e-4, 7.019e-05, 2.1328e-4, 1.04e-06, -1.2e-08, 2.12e-06),
                 **shapes(cap, 0.025, 0.05, (0, 0.06, 0.01))),
        LinkSpec("Lower_Arm", "Upper_Arm", HINGE, "elbow_flex", origin_pos=(0, 0.11257, 0.028), axis=(1, 0, 0),
                 limit=(-1.5708, 1.5708), armature=0.02, mass=0.148, com=(-0.0034, 0.0014, 0.0768),
                 inertia=_inertia(1.0533e-4, 1.3877e-4, 5.087e-05, 1.7e-07, -1.17e-05, 1.77e-06),
                 **shapes(cap, 0.022, 0.05, (0, 0, 0.07))),
        LinkSpec("Wrist_Pitch_Roll", "Lower_Arm", HINGE, "wrist_flex", origin_pos=(0, 0.0052, 0.1349),
                 origin_quat=_rpy(-1.5708, 0, 0), axis=(1, 0, 0), limit=(-1.8, 1.8), armature=0.01, mass=0.0661,
                 com=(-0.0085, -0.0352, -2.3e-05),
                 inertia=_inertia(1.957e-05, 2.38e-05, 3.454e-05, -6.6e-07, 5.2e-09, 4.1e-08),
                 **shapes(cap, 0.02, 0.02, (0, -0.03, 0))),
        LinkSpec("Fixed_Jaw", "Wrist_Pitch_Roll", HINGE, "wrist_roll", origin_pos=(0, -0.0601, 0),
                 origin_quat=_rpy(0, 1.5708, 0), axis=(0, 1, 0), limit=(-3.14159, 3.14159), armature=0.01,
                 mass=0.093, com=(0.0055, -0.028, 0.00048),
                 inertia=_inertia(4.333e-05, 3.045e-05, 5.025e-05, 7.1e-06, 6.0e-07, -1.6e-07),
                 **shapes(box, (0.012, 0.045, 0.012), (0.009, -0.05, 0))),
        LinkSpec("Moving_Jaw", "Fixed_Jaw", HINGE, "gripper", origin_pos=(-0.0202, -0.0244, 0),
                 origin_quat=_rpy(0, 3.14159, -0.9), axis=(0, 0, 1), limit=(-1.1, 1.1), armature=0.01,
                 mass=0.0202, com=(-0.0016, -0.0303, 0.00045),
                 inertia=_inertia(1.109e-05, 3.04e-06, 8.99e-06, -5.4e-07, -9.5e-09, -1.7e-07),
                 **shapes(box, (0.01, 0.035, 0.01), (-0.005, -0.04, 0))),
        LinkSpec("Fixed_Jaw_tip", "Fixed_Jaw", FIXED, "Fixed_Jaw_tip_joint", origin_pos=(0.01, -0.097, 0),
                 mass=1e-4, inertia=np.full(3, 1e-8)),
    ]
    jmap = dict(zip(JOINT_NAMES, joint_names or JOINT_NAMES))
    out = []
    for link in links:
        kw = dict(name=prefix + link.name)
        if link.parent is None:
            kw["parent"] = parent
            if parent is not None:
                kw.update(joint_type=FIXED, joint_name=prefix + "Base_mount", origin_pos=tuple(origin_pos),
                          origin_quat=tuple(origin_quat))
        else:
            kw["parent"] = prefix + link.parent
            kw["joint_name"] = jmap.get(link.joint_name, prefix + link.joint_name)
        out.append(dataclasses.replace(link, **kw))
    return out


class _SO100Mixin:
    """Controllers and gripper checks shared by the SO100-family agents."""

    @property
    def _controller_configs(self):
        common_kw = dict(joint_names=JOINT_NAMES, stiffness=1e3, damping=1e2, force_limit=100)
        pd_joint_pos = PDJointPosControllerConfig(**common_kw, lower=None, upper=None, normalize_action=False)
        pd_joint_delta_pos = PDJointPosControllerConfig(**common_kw, lower=-0.1, upper=0.1, use_delta=True)
        pd_joint_target_delta_pos = PDJointPosControllerConfig(**common_kw, lower=-0.1, upper=0.1, use_delta=True,
                                                               use_target=True)
        return dict(
            pd_joint_delta_pos=dict(arm=pd_joint_delta_pos),
            pd_joint_pos=dict(arm=pd_joint_pos),
            pd_joint_target_delta_pos=dict(arm=pd_joint_target_delta_pos),
        )

    def _after_init(self):
        self.tcp = self.robot.links_map["Fixed_Jaw_tip"]
        self.finger1_link = self.robot.links_map["Fixed_Jaw"]
        self.finger2_link = self.robot.links_map["Moving_Jaw"]
        self._close_dir = torch.tensor([0.0, -1.0, 0.0], device=self.scene.device)

    @property
    def tcp_pose(self):
        return self.tcp.pose

    def is_grasping(self, object, min_force=0.5, max_angle=110.0):
        """Both jaws press ``object`` with at least ``min_force`` N, each
        force within ``max_angle`` degrees of its jaw's -y axis."""
        l_forces = self.scene.get_pairwise_contact_forces(self.finger1_link, object)
        r_forces = self.scene.get_pairwise_contact_forces(self.finger2_link, object)
        lforce = torch.linalg.vector_norm(l_forces, dim=-1)
        rforce = torch.linalg.vector_norm(r_forces, dim=-1)
        langle = common.compute_angle_between(quaternion_apply(self.finger1_link.pose.q, self._close_dir), l_forces)
        rangle = common.compute_angle_between(quaternion_apply(self.finger2_link.pose.q, self._close_dir), r_forces)
        return ((lforce >= min_force) & (torch.rad2deg(langle) <= max_angle)
                & (rforce >= min_force) & (torch.rad2deg(rangle) <= max_angle))

    def is_static(self, threshold: float = 0.2):
        return torch.amax(torch.abs(self.robot.qvel[..., :-1]), 1) <= threshold


@register_agent()
class SO100(_SO100Mixin, BaseAgent):
    uid = "so100"
    fix_root_link = True
    disable_self_collisions = True

    keyframes = dict(
        rest=Keyframe(qpos=np.array([0, -1.5708, 1.5708, 0.66, 0, -1.1]), pose=np.array([0, 0, 0, 1, 0, 0, 0])),
        zero=Keyframe(qpos=np.zeros(6), pose=np.array([0, 0, 0, 1, 0, 0, 0])),
    )

    def build_description(self):
        b = ArticulationBuilder(self.scene)
        for link in so100_arm_links():
            b.add_link(link)
        return b
