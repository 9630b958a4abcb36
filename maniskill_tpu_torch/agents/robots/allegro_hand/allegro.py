"""Allegro Hand (counterpart of
maniskill_tpu/agents/robots/allegro_hand/allegro.py).

The 16-dof four-finger hand built from ``LinkSpec``s with the public
allegro_hand_right.urdf constants (box collisions, joint origins and
limits, link masses); the fingertips are 12 mm spheres. The touch variant
reads each tip's net contact force; the left hand is the right one mirrored
across the xz-plane.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ....building.articulation_builder import ArticulationBuilder, LinkSpec, ShapeSpec
from ....physics.types import BOX, FIXED, HINGE, SPHERE
from ...base_agent import BaseAgent, Keyframe
from ...controllers import PDJointPosControllerConfig
from ...registration import register_agent

# (finger root joint origin_pos, origin_rpy-x) for index/middle/ring
_FINGERS = [
    ("ff", (0, 0.0435, -0.001542), -0.08726646255),   # index
    ("mf", (0, 0, 0.0007), 0.0),                       # middle
    ("rf", (0, -0.0435, -0.001542), 0.08726646255),    # ring
]
# per link: (joint origin z, axis, limits, box half-extents, box z-center, mass)
_SEGMENTS = [
    (0.0164, (0, 1, 0), (-0.196, 1.61), (0.0098, 0.01375, 0.027), 0.027, 0.065),
    (0.054, (0, 1, 0), (-0.174, 1.709), (0.0098, 0.01375, 0.0192), 0.0192, 0.0355),
    (0.0384, (0, 1, 0), (-0.227, 1.618), (0.0098, 0.01345, 0.011), 0.0047, 0.02),
]

JOINT_NAMES = [f"joint_{i}.0" for i in range(16)]


def _rotx(a):
    return np.array([np.cos(a / 2), np.sin(a / 2), 0, 0])


def _box(hs, z, mass=None, friction=1.0):
    vol = 8 * hs[0] * hs[1] * hs[2]
    return ShapeSpec(BOX, list(hs), (0, 0, z), friction=friction, density=(mass / vol) if mass else 1000.0)


def _rpy_quat(r, p, y):
    """URDF fixed-axis rpy, R = Rz(y) Ry(p) Rx(r), as a wxyz quaternion."""
    cr, sr = np.cos(r / 2), np.sin(r / 2)
    cp, sp = np.cos(p / 2), np.sin(p / 2)
    cy, sy = np.cos(y / 2), np.sin(y / 2)
    return np.array([
        cy * cp * cr + sy * sp * sr,
        cy * cp * sr - sy * sp * cr,
        cy * sp * cr + sy * cp * sr,
        sy * cp * cr - cy * sp * sr,
    ])


@register_agent()
class AllegroHandRight(BaseAgent):
    uid = "allegro_hand_right"
    fix_root_link = True
    disable_self_collisions = True

    keyframes = dict(
        palm_side=Keyframe(qpos=np.zeros(16), pose=np.array([0, 0, 0.5, 1, 0, 0, 0])),
        palm_up=Keyframe(qpos=np.zeros(16), pose=np.array([0, 0, 0.5, -0.707, 0, 0.707, 0])),
    )

    tip_link_names = [f"link_{i}.0_tip" for i in (3, 7, 11, 15)]
    palm_link_name = "palm"

    def build_description(self):
        b = ArticulationBuilder(self.scene)
        base_shapes = [
            ShapeSpec(BOX, [0.0207, 0.056, 0.0224], (-0.009, 0, -0.023),
                      density=0.4154 / (8 * 0.0207 * 0.056 * 0.0224)),
            ShapeSpec(BOX, [0.0207, 0.0269, 0.0214], (-0.009, -0.0253, -0.0667), density=100.0),
            ShapeSpec(BOX, [0.0207, 0.036, 0.0065], (-0.0093, -0.00557, -0.08874), density=100.0),
        ]
        b.add_link(LinkSpec("base_link", None, collisions=base_shapes, visuals=base_shapes))
        b.add_link(LinkSpec("palm", "base_link", FIXED, "palm_joint", origin_pos=(0, 0, -0.065), mass=1e-4,
                            inertia=np.full(3, 1e-8)))

        # index, middle and ring: a yaw joint and three flexion segments
        for jf, (prefix, org, rx) in enumerate(_FINGERS):
            ji = jf * 4
            hs0 = (0.0098, 0.01375, 0.0082)
            b.add_link(LinkSpec(f"link_{ji}.0", "base_link", HINGE, f"joint_{ji}.0", origin_pos=org,
                                origin_quat=_rotx(rx), axis=(0, 0, 1), limit=(-0.47, 0.47), damping=0.1,
                                armature=0.001, collisions=[_box(hs0, 0.0082, 0.0119)], visuals=[_box(hs0, 0.0082)]))
            parent = f"link_{ji}.0"
            for k, (oz, ax, lim, hs, zc, mass) in enumerate(_SEGMENTS, 1):
                name = f"link_{ji + k}.0"
                b.add_link(LinkSpec(name, parent, HINGE, f"joint_{ji + k}.0", origin_pos=(0, 0, oz), axis=ax,
                                    limit=lim, damping=0.1, armature=0.001,
                                    collisions=[_box(hs, zc, mass, friction=1.5)], visuals=[_box(hs, zc)]))
                parent = name
            tip = [ShapeSpec(SPHERE, [0.012, 0, 0], (0, 0, 0), friction=2.0,
                             density=0.0168 / (4 / 3 * np.pi * 0.012**3))]
            b.add_link(LinkSpec(f"link_{ji + 3}.0_tip", parent, FIXED, f"joint_{ji + 3}.0_tip",
                                origin_pos=(0, 0, 0.0267), collisions=tip, visuals=tip))

        # the thumb: joint_12 (roll) to joint_15
        b.add_link(LinkSpec(
            "link_12.0", "base_link", HINGE, "joint_12.0", origin_pos=(-0.0182, 0.019333, -0.045987),
            origin_quat=_rpy_quat(0, -1.65806278845, -1.5707963259), axis=(-1, 0, 0), limit=(0.263, 1.396),
            damping=0.1, armature=0.001,
            collisions=[ShapeSpec(BOX, [0.0179, 0.017, 0.02275], (-0.0179, 0.009, 0.0145),
                                  density=0.0176 / (8 * 0.0179 * 0.017 * 0.02275))],
            visuals=[ShapeSpec(BOX, [0.0179, 0.017, 0.02275], (-0.0179, 0.009, 0.0145))],
        ))
        thumb = [
            ("link_13.0", "joint_13.0", (-0.027, 0.005, 0.0399), (0, 0, 1),
             (-0.105, 1.163), (0.0098, 0.01375, 0.00885), 0.00885, 0.0119),
            ("link_14.0", "joint_14.0", (0, 0, 0.0177), (0, 1, 0),
             (-0.189, 1.644), (0.0098, 0.01375, 0.0257), 0.0257, 0.038),
            ("link_15.0", "joint_15.0", (0, 0, 0.0514), (0, 1, 0),
             (-0.162, 1.719), (0.0098, 0.01345, 0.02), 0.01125, 0.0388),
        ]
        parent = "link_12.0"
        for name, jname, org, ax, lim, hs, zc, mass in thumb:
            b.add_link(LinkSpec(name, parent, HINGE, jname, origin_pos=org, axis=ax, limit=lim, damping=0.1,
                                armature=0.001, collisions=[_box(hs, zc, mass, friction=1.5)],
                                visuals=[_box(hs, zc)]))
            parent = name
        tip = [ShapeSpec(SPHERE, [0.012, 0, 0], friction=2.0, density=0.0168 / (4 / 3 * np.pi * 0.012**3))]
        b.add_link(LinkSpec("link_15.0_tip", parent, FIXED, "joint_15.0_tip", origin_pos=(0, 0, 0.0423),
                            collisions=tip, visuals=tip))
        return b

    @property
    def _controller_configs(self):
        kw = dict(joint_names=JOINT_NAMES, stiffness=4e2, damping=1e1, force_limit=5e1)
        joint_pos = PDJointPosControllerConfig(**kw, lower=None, upper=None, normalize_action=False)
        delta_pos = PDJointPosControllerConfig(**kw, lower=-0.1, upper=0.1, use_delta=True)
        target_delta_pos = PDJointPosControllerConfig(**kw, lower=-0.1, upper=0.1, use_delta=True, use_target=True)
        return dict(
            pd_joint_delta_pos=dict(hand=delta_pos),
            pd_joint_pos=dict(hand=joint_pos),
            pd_joint_target_delta_pos=dict(hand=target_delta_pos),
        )

    @property
    def tip_links(self):
        return [self.robot.links_map[n] for n in self.tip_link_names]

    @property
    def palm_link(self):
        return self.robot.links_map[self.palm_link_name]

    @property
    def palm_pose(self):
        return self.palm_link.pose.raw_pose

    @property
    def tip_poses(self):
        """(B, 4, 7) fingertip poses."""
        return torch.stack([link.pose.raw_pose for link in self.tip_links], -2)


@register_agent()
class AllegroHandRightTouch(AllegroHandRight):
    """The right hand with per-tip contact forces (the link's net contact
    force stands in for the reference's FSR sensors)."""

    uid = "allegro_hand_right_touch"

    @property
    def tip_contact_forces(self):
        """(B, 4, 3) net contact force on each fingertip."""
        return torch.stack([link.get_net_contact_forces() for link in self.tip_links], -2)


@register_agent()
class AllegroHandLeft(AllegroHandRight):
    """The right hand mirrored across the xz-plane: y -> -y for positions;
    rotation axes and quaternions transform as pseudo-vectors."""

    uid = "allegro_hand_left"

    def build_description(self):
        b = super().build_description()
        for i, spec in enumerate(b.links):
            pos = np.asarray(spec.origin_pos, np.float64).copy()
            pos[1] = -pos[1]
            q = np.asarray(spec.origin_quat, np.float64).copy()
            q[1], q[3] = -q[1], -q[3]  # (w, x, y, z) -> (w, -x, y, -z)
            ax = np.asarray(spec.axis, np.float64).copy()
            ax[0], ax[2] = -ax[0], -ax[2]
            shapes = {}
            for field in ("collisions", "visuals"):
                new = []
                for s in getattr(spec, field):
                    sp = np.asarray(s.pos, np.float64).copy()
                    sp[1] = -sp[1]
                    sq = np.asarray(s.quat, np.float64).copy()
                    sq[1], sq[3] = -sq[1], -sq[3]
                    new.append(dataclasses.replace(s, pos=tuple(sp), quat=tuple(sq)))
                shapes[field] = new
            b.links[i] = dataclasses.replace(spec, origin_pos=tuple(pos), origin_quat=tuple(q), axis=tuple(ax),
                                             **shapes)
        return b
