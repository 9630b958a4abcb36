"""Fetch mobile manipulator (counterpart of
maniskill_tpu/agents/robots/fetch/fetch.py).

The kinematic tree, joint limits, masses and PD gains are the public Fetch
description's; collision shapes are primitives (cylinder base, box torso
and head, capsule arm links, box fingers). The planar base is a chain of
dummy links: x-slide -> y-slide -> z-hinge, driven by a forward-velocity
base controller.
"""
from __future__ import annotations

import numpy as np
import torch

from ....building.articulation_builder import ArticulationBuilder, LinkSpec, ShapeSpec
from ....physics.types import BOX, CAPSULE, CYLINDER, FIXED, HINGE, SLIDE
from ....sensors.camera import CameraConfig
from ....utils import common
from ....utils.geometry.rotation_conversions import quaternion_apply
from ...base_agent import BaseAgent, Keyframe
from ...controllers import (
    PDBaseForwardVelControllerConfig,
    PDJointPosControllerConfig,
    PDJointPosMimicControllerConfig,
)
from ...registration import register_agent

ARM_JOINT_NAMES = [
    "shoulder_pan_joint", "shoulder_lift_joint", "upperarm_roll_joint",
    "elbow_flex_joint", "forearm_roll_joint", "wrist_flex_joint",
    "wrist_roll_joint",
]
GRIPPER_JOINT_NAMES = ["l_gripper_finger_joint", "r_gripper_finger_joint"]
BODY_JOINT_NAMES = ["head_pan_joint", "head_tilt_joint", "torso_lift_joint"]
BASE_JOINT_NAMES = ["root_x_axis_joint", "root_y_axis_joint", "root_z_rotation_joint"]

_DUMMY = dict(mass=1e-4, inertia=np.full(3, 1e-8))


def _capx(length, r, friction=1.0, density=1000.0):
    """Capsule along +x from the origin to (length, 0, 0)."""
    return ShapeSpec(
        CAPSULE, [r, length / 2, 0], (length / 2, 0, 0),
        (0.7071068, 0, 0.7071068, 0), friction=friction, density=density,
    )


@register_agent()
class Fetch(BaseAgent):
    uid = "fetch"
    fix_root_link = True
    disable_self_collisions = True

    keyframes = dict(
        rest=Keyframe(
            qpos=np.array(
                [0, 0, 0,  # base x, y, theta
                 0.386, 0, 0,  # torso lift, head pan, head tilt
                 0.562, -1.032, 0.695, 0.955, -0.1, 2.077, 0,  # arm
                 0.015, 0.015]  # fingers
            ),
            pose=np.array([0, 0, 0, 1, 0, 0, 0]),
        )
    )

    def build_description(self):
        b = ArticulationBuilder(self.scene)
        b.add_link(LinkSpec("root", None))
        b.add_link(LinkSpec("root_arm_1_link_1", "root", SLIDE, "root_x_axis_joint",
                            axis=(1, 0, 0), limit=(-20, 20), **_DUMMY))
        b.add_link(LinkSpec("root_arm_1_link_2", "root_arm_1_link_1", SLIDE, "root_y_axis_joint",
                            axis=(0, 1, 0), limit=(-20, 20), **_DUMMY))
        base_shapes = [ShapeSpec(CYLINDER, [0.28, 0.115, 0], (0, 0, 0.17), friction=0.0,
                                 density=70.13 / (np.pi * 0.28**2 * 0.23))]
        b.add_link(LinkSpec("base_link", "root_arm_1_link_2", HINGE, "root_z_rotation_joint",
                            axis=(0, 0, 1), collisions=base_shapes, visuals=base_shapes))
        torso = [ShapeSpec(BOX, [0.11, 0.14, 0.26], (-0.02, 0, 0.18), density=10.78 / (0.22 * 0.28 * 0.52))]
        b.add_link(LinkSpec("torso_lift_link", "base_link", SLIDE, "torso_lift_joint",
                            origin_pos=(-0.086875, 0, 0.37743), axis=(0, 0, 1), limit=(0.0, 0.38615),
                            damping=50.0, collisions=torso, visuals=torso))
        b.add_link(LinkSpec("head_pan_link", "torso_lift_link", HINGE, "head_pan_joint",
                            origin_pos=(0.053125, 0, 0.603001), axis=(0, 0, 1), limit=(-1.57, 1.57),
                            mass=2.2556, inertia=np.full(3, 0.01)))
        head = [ShapeSpec(BOX, [0.11, 0.08, 0.065], (0.02, 0, 0.03), density=0.91 / (0.22 * 0.16 * 0.13))]
        b.add_link(LinkSpec("head_tilt_link", "head_pan_link", HINGE, "head_tilt_joint",
                            origin_pos=(0.14253, 0, 0.057999), axis=(0, 1, 0), limit=(-0.76, 1.45),
                            collisions=head, visuals=head))
        b.add_link(LinkSpec("head_camera_link", "head_tilt_link", FIXED, "head_camera_joint",
                            origin_pos=(0.055, 0, 0.0225), **_DUMMY))
        # the 7-dof arm off the torso: capsules with densities that land near
        # the description's link masses
        arm = [
            # (name, joint, origin, axis, limit, capsule length, radius, mass)
            ("shoulder_pan_link", "shoulder_pan_joint", (0.119525, 0, 0.34858),
             (0, 0, 1), (-1.6056, 1.6056), 0.117, 0.06, 2.5587),
            ("shoulder_lift_link", "shoulder_lift_joint", (0.117, 0, 0.06),
             (0, 1, 0), (-1.221, 1.518), 0.219, 0.055, 2.6615),
            ("upperarm_roll_link", "upperarm_roll_joint", (0.219, 0, 0),
             (1, 0, 0), (-np.inf, np.inf), 0.133, 0.05, 2.3311),
            ("elbow_flex_link", "elbow_flex_joint", (0.133, 0, 0),
             (0, 1, 0), (-2.251, 2.251), 0.197, 0.05, 2.1299),
            ("forearm_roll_link", "forearm_roll_joint", (0.197, 0, 0),
             (1, 0, 0), (-np.inf, np.inf), 0.1245, 0.045, 1.6563),
            ("wrist_flex_link", "wrist_flex_joint", (0.1245, 0, 0),
             (0, 1, 0), (-2.16, 2.16), 0.1385, 0.04, 1.725),
            ("wrist_roll_link", "wrist_roll_joint", (0.1385, 0, 0),
             (1, 0, 0), (-np.inf, np.inf), 0.09, 0.04, 0.1354),
        ]
        parent = "torso_lift_link"
        for name, jname, origin, axis, lim, clen, cr, mass in arm:
            vol = np.pi * cr * cr * clen + 4 / 3 * np.pi * cr**3
            shapes = [_capx(clen, cr, density=mass / vol)]
            b.add_link(LinkSpec(name, parent, HINGE, jname, origin_pos=origin, axis=axis, limit=lim,
                                damping=1.0, armature=0.01, collisions=shapes, visuals=shapes))
            parent = name
        gl = [ShapeSpec(BOX, [0.04, 0.05, 0.028], (0.0, 0, 0), density=1.5175 / (0.08 * 0.1 * 0.056))]
        b.add_link(LinkSpec("gripper_link", "wrist_roll_link", FIXED, "gripper_axis",
                            origin_pos=(0.16645, 0, 0), collisions=gl, visuals=gl))
        finger = [ShapeSpec(BOX, [0.035, 0.007, 0.014], (0.02, 0, 0), friction=2.0,
                            density=0.0798 / (0.07 * 0.014 * 0.028))]
        b.add_link(LinkSpec("r_gripper_finger_link", "gripper_link", SLIDE, "r_gripper_finger_joint",
                            origin_pos=(0, 0.015425, 0), axis=(0, 1, 0), limit=(0.0, 0.05), damping=10.0,
                            collisions=finger, visuals=finger))
        b.add_link(LinkSpec("l_gripper_finger_link", "gripper_link", SLIDE, "l_gripper_finger_joint",
                            origin_pos=(0, -0.015425, 0), axis=(0, -1, 0), limit=(0.0, 0.05), damping=10.0,
                            collisions=finger, visuals=finger))
        return b

    @property
    def _controller_configs(self):
        arm_common = dict(joint_names=ARM_JOINT_NAMES, stiffness=1e3, damping=1e2, force_limit=100)
        arm_pd_joint_pos = PDJointPosControllerConfig(**arm_common, lower=None, upper=None, normalize_action=False)
        arm_pd_joint_delta_pos = PDJointPosControllerConfig(**arm_common, lower=-0.1, upper=0.1, use_delta=True)
        gripper = PDJointPosMimicControllerConfig(
            joint_names=GRIPPER_JOINT_NAMES, lower=0.0, upper=0.05, stiffness=1e3, damping=1e2, force_limit=100,
        )
        body = PDJointPosControllerConfig(
            joint_names=BODY_JOINT_NAMES, lower=None, upper=None, stiffness=1e3, damping=1e2, force_limit=100,
            normalize_action=True,
        )
        base = PDBaseForwardVelControllerConfig(
            joint_names=BASE_JOINT_NAMES, lower=[-1, -3.14], upper=[1, 3.14], damping=1000, force_limit=500,
        )
        return dict(
            pd_joint_delta_pos=dict(arm=arm_pd_joint_delta_pos, gripper=gripper, body=body, base=base),
            pd_joint_pos=dict(arm=arm_pd_joint_pos, gripper=gripper, body=body, base=base),
        )

    @property
    def _sensor_configs(self):
        return [
            CameraConfig("fetch_head", np.array([0, 0, 0, 1, 0, 0, 0]), 128, 128, np.pi / 2, 0.01, 100,
                         mount=self.robot.links_map["head_camera_link"]),
            CameraConfig("fetch_hand", np.array([-0.1, 0, 0.1, 1, 0, 0, 0]), 128, 128, np.pi / 2, 0.01, 100,
                         mount=self.robot.links_map["gripper_link"]),
        ]

    def _after_init(self):
        dev = self.scene.device
        self.l_finger = self.robot.links_map["l_gripper_finger_link"]
        self.r_finger = self.robot.links_map["r_gripper_finger_link"]
        # the fingers open along their slide axes (l: -y, r: +y), so they
        # close along the opposite directions
        self._l_close = torch.tensor([0.0, 1.0, 0.0], device=dev)
        self._r_close = torch.tensor([0.0, -1.0, 0.0], device=dev)

    @property
    def tcp(self):
        return self.robot.links_map["gripper_link"]

    @property
    def tcp_pose(self):
        # PickClutterYCB's state obs reads it (the JAX package's Fetch lacks
        # it, so its PickClutterYCB runs the Fetch with obs_mode "none" only)
        return self.tcp.pose

    def is_grasping(self, object=None, min_force=0.5, max_angle=85.0):
        """Both fingers push on ``object`` with at least ``min_force`` N, each
        within ``max_angle`` degrees of its closing direction."""
        l_forces = self.scene.get_pairwise_contact_forces(self.l_finger, object)
        r_forces = self.scene.get_pairwise_contact_forces(self.r_finger, object)
        lforce = torch.linalg.vector_norm(l_forces, dim=-1)
        rforce = torch.linalg.vector_norm(r_forces, dim=-1)
        ldirection = quaternion_apply(self.l_finger.pose.q, self._l_close)
        rdirection = quaternion_apply(self.r_finger.pose.q, self._r_close)
        langle = common.compute_angle_between(ldirection, l_forces)
        rangle = common.compute_angle_between(rdirection, r_forces)
        lflag = (lforce >= min_force) & (torch.rad2deg(langle) <= max_angle)
        rflag = (rforce >= min_force) & (torch.rad2deg(rangle) <= max_angle)
        return lflag & rflag
