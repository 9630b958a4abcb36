"""XLeRobot (counterpart of maniskill_tpu/agents/robots/xlerobot/xlerobot.py):
two SO-ARM100 arms (``so100_arm_links``) and a pan/tilt head on a planar
mobile base, built from ``LinkSpec``s. Joint names follow the reference:
Rotation/Pitch/Elbow/Wrist_Pitch/Wrist_Roll/Jaw and the ``_2`` arm, the
``root_*`` base joints and the head's pan and tilt."""
from __future__ import annotations

import numpy as np
import torch

from ....building.articulation_builder import ArticulationBuilder, LinkSpec, ShapeSpec
from ....physics.types import BOX, CYLINDER, HINGE, SLIDE
from ....sensors.camera import CameraConfig
from ...base_agent import BaseAgent, Keyframe
from ...controllers import PDBaseVelControllerConfig, PDJointPosControllerConfig
from ...registration import register_agent
from ..so100.so100 import so100_arm_links

ARM1_JOINTS = ["Rotation", "Pitch", "Elbow", "Wrist_Pitch", "Wrist_Roll"]
ARM2_JOINTS = [f"{j}_2" for j in ARM1_JOINTS]
BASE_JOINTS = ["root_x_axis_joint", "root_y_axis_joint", "root_z_rotation_joint"]
HEAD_JOINTS = ["head_pan_joint", "head_tilt_joint"]


@register_agent()
class Xlerobot(BaseAgent):
    uid = "xlerobot"
    fix_root_link = True
    disable_self_collisions = True

    # the builder's dof order: base (3), arm 1 (6), arm 2 (6), head (2)
    keyframes = dict(rest=Keyframe(
        qpos=np.concatenate([np.zeros(3), np.array([0, -1.5708, 1.5708, 0.66, 0, -1.1]),
                             np.array([0, -1.5708, 1.5708, 0.66, 0, -1.1]), np.zeros(2)]),
        pose=np.array([0, 0, 0, 1, 0, 0, 0]),
    ))

    def build_description(self):
        b = ArticulationBuilder(self.scene)
        tiny = dict(mass=1e-3, inertia=np.full(3, 1e-7))
        # planar virtual base
        b.add_link(LinkSpec("root", None))
        b.add_link(LinkSpec("root_arm_1_link_1", "root", SLIDE, "root_x_axis_joint", axis=(1, 0, 0),
                            limit=(-10, 10), damping=1e3, **tiny))
        b.add_link(LinkSpec("root_arm_1_link_2", "root_arm_1_link_1", SLIDE, "root_y_axis_joint", axis=(0, 1, 0),
                            limit=(-10, 10), damping=1e3, **tiny))
        base_shape = [ShapeSpec(CYLINDER, [0.18, 0.07, 0], (0, 0, 0.08), friction=1.0),
                      ShapeSpec(BOX, [0.1, 0.14, 0.26], (0, 0, 0.42), friction=0.8)]
        b.add_link(LinkSpec("base_link", "root_arm_1_link_2", HINGE, "root_z_rotation_joint", axis=(0, 0, 1),
                            limit=(-100, 100), damping=1e3, mass=12.0, collisions=base_shape, visuals=base_shape))
        # two SO100 arms on the torso shelf, facing +x
        for prefix, names, y in (("arm1_", ARM1_JOINTS + ["Jaw"], 0.11), ("arm2_", ARM2_JOINTS + ["Jaw_2"], -0.11)):
            for link in so100_arm_links(prefix=prefix, parent="base_link", origin_pos=(0.12, y, 0.70),
                                        origin_quat=(np.cos(np.pi / 4), 0, 0, -np.sin(np.pi / 4)), joint_names=names):
                b.add_link(link)
        # head pan/tilt with the camera mount
        b.add_link(LinkSpec("head_pan_link", "base_link", HINGE, "head_pan_joint", origin_pos=(0, 0, 0.75),
                            axis=(0, 0, 1), limit=(-2.7, 2.7), **tiny))
        head = [ShapeSpec(BOX, [0.06, 0.08, 0.05], (0.02, 0, 0.03), friction=0.5)]
        b.add_link(LinkSpec("head_camera_link", "head_pan_link", HINGE, "head_tilt_joint", origin_pos=(0, 0, 0.03),
                            axis=(0, 1, 0), limit=(-1.2, 1.2), mass=0.6, collisions=head, visuals=head))
        return b

    @property
    def _controller_configs(self):
        def arm_cfg(joints):
            return PDJointPosControllerConfig(joint_names=joints, lower=-0.1, upper=0.1, stiffness=2e4, damping=1e2,
                                              force_limit=250, use_delta=True)

        def jaw_cfg(joints):
            return PDJointPosControllerConfig(joint_names=joints, lower=None, upper=None, stiffness=50, damping=10,
                                              force_limit=2.8, normalize_action=False)

        base = PDBaseVelControllerConfig(joint_names=BASE_JOINTS, lower=[-0.5, -0.5, -3.14], upper=[0.5, 0.5, 3.14],
                                         damping=1000, force_limit=500)
        head = PDJointPosControllerConfig(joint_names=HEAD_JOINTS, lower=-0.1, upper=0.1, stiffness=1e4, damping=1e2,
                                          force_limit=200, use_delta=True)
        return dict(pd_joint_delta_pos_dual_arm=dict(
            arm1=arm_cfg(ARM1_JOINTS), gripper1=jaw_cfg(["Jaw"]), arm2=arm_cfg(ARM2_JOINTS),
            gripper2=jaw_cfg(["Jaw_2"]), head=head, base=base,
        ))

    def _after_init(self):
        self.tcp = self.robot.links_map["arm1_Fixed_Jaw_tip"]
        self.tcp2 = self.robot.links_map["arm2_Fixed_Jaw_tip"]

    @property
    def _sensor_configs(self):
        return [CameraConfig(uid="fetch_head", pose=np.array([0.06, 0, 0.02, 1, 0, 0, 0]), width=128, height=128,
                             fov=2, near=0.01, far=100, mount=self.robot.links_map["head_camera_link"])]

    def is_static(self, threshold: float = 0.2):
        return torch.amax(torch.abs(self.robot.qvel[..., 3:15]), 1) <= threshold
