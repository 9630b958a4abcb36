"""The whole Unitree G1 humanoid and its fixed-base upper-body variants
(counterpart of maniskill_tpu/agents/robots/unitree_g1/g1_full.py).

37-dof whole body (12 leg, torso, 10 arm and 14 rubber-hand joints) from the
port's copy of the compact URDF; the upper body welds the legs (25 dofs).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .... import PACKAGE_ASSET_DIR
from ....sensors.camera import CameraConfig
from ....utils import common
from ....utils.geometry.rotation_conversions import quaternion_apply
from ...base_agent import BaseAgent, Keyframe
from ...controllers import PassiveControllerConfig, PDJointPosControllerConfig
from ...registration import register_agent

_DIR = os.path.join(PACKAGE_ASSET_DIR, "robots", "unitree_g1")

_LEG = ["hip_pitch", "hip_roll", "hip_yaw", "knee", "ankle_pitch", "ankle_roll"]
_ARM = ["shoulder_pitch", "shoulder_roll", "shoulder_yaw", "elbow_pitch", "elbow_roll"]
_HAND = ["zero", "one", "two", "three", "four", "five", "six"]

# URDF declaration order: legs L, legs R, torso, (arm + hand) L, (arm + hand) R
FULL_JOINT_NAMES = (
    [f"left_{j}_joint" for j in _LEG]
    + [f"right_{j}_joint" for j in _LEG]
    + ["torso_joint"]
    + [f"left_{j}_joint" for j in _ARM + _HAND]
    + [f"right_{j}_joint" for j in _ARM + _HAND]
)

# the standing keyframe, keyed by joint name
_STANDING = {n: 0.0 for n in FULL_JOINT_NAMES}
_STANDING.update({
    "left_shoulder_roll_joint": 0.2, "right_shoulder_roll_joint": -0.2,
    "left_elbow_pitch_joint": 0.9, "right_elbow_pitch_joint": 0.9,
    "left_one_joint": 0.1, "right_one_joint": -0.1,
    "left_two_joint": 0.92, "right_two_joint": -0.92,
    "left_three_joint": -0.77, "right_three_joint": 0.77,
    "left_four_joint": -0.92, "right_four_joint": 0.92,
    "left_five_joint": -0.77, "right_five_joint": 0.77,
    "left_six_joint": -0.92, "right_six_joint": 0.92,
})


def _kf(names, overrides=None):
    vals = dict(_STANDING)
    vals.update(overrides or {})
    return np.array([vals[n] for n in names])


def _pd_modes(agent):
    """pd_joint_pos and pd_joint_delta_pos over ``agent.body_joints``."""
    common_kw = dict(
        joint_names=list(agent.body_joints), stiffness=agent.body_stiffness,
        damping=agent.body_damping, force_limit=agent.body_force_limit,
    )
    return dict(
        pd_joint_pos=PDJointPosControllerConfig(**common_kw, lower=None, upper=None, normalize_action=False),
        pd_joint_delta_pos=PDJointPosControllerConfig(**common_kw, lower=-0.2, upper=0.2, use_delta=True),
    )


@register_agent()
class UnitreeG1(BaseAgent):
    uid = "unitree_g1"
    urdf_path = os.path.join(_DIR, "g1.urdf")
    fix_root_link = False
    disable_self_collisions = True

    body_joints = FULL_JOINT_NAMES
    body_stiffness = 50
    body_damping = 1
    body_force_limit = 100

    keyframes = dict(
        standing=Keyframe(pose=np.array([0, 0, 0.755, 1, 0, 0, 0]), qpos=_kf(FULL_JOINT_NAMES)),
        right_knee_up=Keyframe(
            pose=np.array([0, 0, 0.755, 1, 0, 0, 0]),
            qpos=_kf(FULL_JOINT_NAMES, {"right_hip_pitch_joint": -1.5, "right_knee_joint": 1.5}),
        ),
        left_knee_up=Keyframe(
            pose=np.array([0, 0, 0.755, 1, 0, 0, 0]),
            qpos=_kf(FULL_JOINT_NAMES, {"left_hip_pitch_joint": -1.5, "left_knee_joint": 1.5}),
        ),
    )

    @property
    def _controller_configs(self):
        return {mode: dict(body=cfg, balance_passive_force=False) for mode, cfg in _pd_modes(self).items()}

    def is_standing(self):
        z = self.robot.pose.p[:, 2]
        return (z > 0.5) & (z < 1.0)

    def is_fallen(self):
        return self.robot.pose.p[:, 2] < 0.3


UPPER_JOINT_NAMES = (
    ["torso_joint"]
    + [f"left_{j}_joint" for j in _ARM + _HAND]
    + [f"right_{j}_joint" for j in _ARM + _HAND]
)


@register_agent()
class UnitreeG1UpperBody(BaseAgent):
    """Fixed-base upper body for tabletop humanoid manipulation (the legs
    are welded)."""

    uid = "unitree_g1_simplified_upper_body"
    urdf_path = os.path.join(_DIR, "g1_simplified_upper_body.urdf")
    fix_root_link = True
    disable_self_collisions = True

    body_joints = UPPER_JOINT_NAMES
    body_stiffness = 1e3
    body_damping = 1e2
    body_force_limit = 100

    keyframes = dict(
        standing=Keyframe(pose=np.array([0, 0, 0.755, 1, 0, 0, 0]), qpos=np.zeros(len(UPPER_JOINT_NAMES)))
    )

    @property
    def _controller_configs(self):
        cfgs = {mode: dict(body=cfg) for mode, cfg in _pd_modes(self).items()}
        passive_joints = [n for n in UPPER_JOINT_NAMES if n not in self.body_joints]
        if passive_joints:
            passive = PassiveControllerConfig(joint_names=passive_joints, damping=1.0, force_limit=100)
            for c in cfgs.values():
                c["passive"] = passive
        return cfgs

    def _after_init(self):
        names = [j.name for j in self.robot.active_joints]
        dev = self.scene.device
        self._finger_joints = {side: [names.index(f"{side}_{k}_joint") for k in _HAND] for side in ("left", "right")}
        self._finger_idx = {side: torch.tensor(ix, device=dev) for side, ix in self._finger_joints.items()}
        # closing directions of the thumb and finger chains in the palm frame
        self._close_dirs = {
            side: torch.tensor([[0.0, -sgn, 0.0], [0.0, sgn, 0.0]], device=dev)
            for side, sgn in (("left", 1.0), ("right", -1.0))
        }

    @property
    def left_tcp(self):
        return self.robot.links_map["left_palm_link"]

    @property
    def right_tcp(self):
        return self.robot.links_map["right_palm_link"]

    @property
    def left_finger_joint_indexes(self):
        return self._finger_joints["left"]

    @property
    def right_finger_joint_indexes(self):
        return self._finger_joints["right"]

    def right_hand_dist_to_open_grasp(self):
        """Mean |qpos| of the right-hand joints: 0 when the hand is open."""
        return torch.mean(torch.abs(self.robot.qpos[:, self._finger_idx["right"]]), 1)

    def left_hand_dist_to_open_grasp(self):
        return torch.mean(torch.abs(self.robot.qpos[:, self._finger_idx["left"]]), 1)

    def _hand_is_grasping(self, side, obj, min_force=0.5, max_angle=85.0):
        """Opposed-contact grasp: the thumb chain (``five``) and the finger
        chain (``three``) both press on ``obj`` within ``max_angle`` of their
        closing directions along the palm's y axis."""
        thumb = self.robot.links_map[f"{side}_five_link"]
        finger = self.robot.links_map[f"{side}_three_link"]
        f_thumb = self.scene.get_pairwise_contact_forces(thumb, obj)
        f_finger = self.scene.get_pairwise_contact_forces(finger, obj)
        lforce = torch.linalg.vector_norm(f_thumb, dim=-1)
        rforce = torch.linalg.vector_norm(f_finger, dim=-1)
        palm_q = self.robot.links_map[f"{side}_palm_link"].pose.q
        dirs = self._close_dirs[side]
        langle = common.compute_angle_between(quaternion_apply(palm_q, dirs[0]), f_thumb)
        rangle = common.compute_angle_between(quaternion_apply(palm_q, dirs[1]), f_finger)
        lflag = (lforce >= min_force) & (torch.rad2deg(langle) <= max_angle)
        rflag = (rforce >= min_force) & (torch.rad2deg(rangle) <= max_angle)
        return lflag & rflag

    def right_hand_is_grasping(self, obj, min_force=0.5, max_angle=85.0):
        return self._hand_is_grasping("right", obj, min_force, max_angle)

    def left_hand_is_grasping(self, obj, min_force=0.5, max_angle=85.0):
        return self._hand_is_grasping("left", obj, min_force, max_angle)


@register_agent()
class UnitreeG1UpperBodyWithHeadCamera(UnitreeG1UpperBody):
    uid = "unitree_g1_simplified_upper_body_with_head_camera"

    @property
    def _sensor_configs(self):
        # the head camera, pitched down 30 degrees
        q = np.array([np.cos(np.pi / 12), 0, np.sin(np.pi / 12), 0])
        return [
            CameraConfig(
                uid="head_camera", pose=np.concatenate([[0.05, 0, 0.46], q]),
                width=128, height=128, fov=np.pi / 2, near=0.01, far=100,
                mount=self.robot.links_map["torso_link"],
            )
        ]


@register_agent()
class UnitreeG1UpperBodyRightArm(UnitreeG1UpperBody):
    """Right-arm control only; every other joint runs passive."""

    uid = "unitree_g1_simplified_upper_body_right_arm"

    body_joints = [f"right_{j}_joint" for j in _ARM] + [f"right_{j}_joint" for j in _HAND]
