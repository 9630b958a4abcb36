"""UnitreeG1TransportBox-v1 (counterpart of
maniskill_tpu/envs/tasks/humanoid/transport_box.py).

The G1 upper body stands between two tables. It must hug-lift the cardboard
box from the table at y = -0.66 (the torso turned toward it), carry it by
twisting the torso, and set it down on the table at y = +0.66. Success: the
box resting on the target table and not held. The box's x is drawn in
[-0.05, 0.2] and its y within +/-0.05 of (-0.1, -0.37), its yaw in
[0, pi/6]. Staged dense reward face -> grasp -> transport -> release.
"""
from __future__ import annotations

import numpy as np
import torch

from ....building.ground import build_ground
from ....sensors.camera import CameraConfig
from ....structs.pose import Pose
from ....utils.registration import register_env
from ....utils.scene_utils import look_at
from ...base_env import BaseEnv

_TABLE_HALF = (0.829028571, 0.4145142855, 0.315306137)
_TABLE_TOP = 2 * _TABLE_HALF[2]  # 0.6306


@register_env("UnitreeG1TransportBox-v1", max_episode_steps=100)
class TransportBoxEnv(BaseEnv):
    SUPPORTED_ROBOTS = ["unitree_g1_simplified_upper_body_with_head_camera"]
    box_half_size = (0.18, 0.12, 0.12)

    def __init__(self, *args, **kwargs):
        kwargs.pop("robot_uids", None)
        super().__init__(*args, robot_uids="unitree_g1_simplified_upper_body_with_head_camera", **kwargs)

    @property
    def _default_sensor_configs(self):
        pose = look_at([1.0, 0.0, 1.6], [0, 0.0, 0.65])
        return [CameraConfig("base_camera", pose, 128, 128, np.pi / 3, 0.01, 100)]

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at([1.0, 0.0, 1.6], [0, 0.0, 0.65])
        return CameraConfig("render_camera", pose, 512, 512, np.pi / 3, 0.01, 100)

    def _load_agent(self, options: dict):
        super()._load_agent(options, np.array([-0.1, 0, 0.755, 1, 0, 0, 0]))

    def _load_scene(self, options: dict):
        self.ground = build_ground(self.scene)
        half = np.array(_TABLE_HALF)
        for i, y in enumerate((0.66, -0.66)):
            b = self.scene.create_actor_builder()
            top_pose = np.array([0, 0, half[2], 1, 0, 0, 0])
            b.add_box_collision(pose=top_pose, half_size=half, friction=0.6)
            b.add_box_visual(pose=top_pose, half_size=half, color=(0.57, 0.43, 0.30, 1.0))
            b.set_initial_pose(np.array([0, y, 0, 1, 0, 0, 0]))
            setattr(self, f"table_{i + 1}", b.build_static(f"table-{i + 1}"))

        b = self.scene.create_actor_builder()
        b.add_box_collision(half_size=self.box_half_size, density=200, friction=1.0)
        b.add_box_visual(half_size=self.box_half_size, color=(0.76, 0.6, 0.42, 1))
        b.set_initial_pose(np.array([-0.1, -0.37, 0.7508, 1, 0, 0, 0]))
        self.box = b.build_dynamic("box")

        names = [j.name for j in self.agent.robot.active_joints]
        self._torso_idx = names.index("torso_joint")
        self._l_roll_idx = names.index("left_shoulder_roll_joint")
        self._r_roll_idx = names.index("right_shoulder_roll_joint")

        # the arms spread laterally, ready to hug the box
        qpos = np.asarray(self.agent.keyframes["standing"].qpos, np.float32).copy()
        qpos[self._l_roll_idx] = 1.25
        qpos[self._r_roll_idx] = -1.25
        dev = self.device
        self._hug_qpos = torch.as_tensor(qpos, device=dev)[None]
        # the box's side grasp points in its own frame
        self._right_grasp_local, self._left_grasp_local = (
            Pose(torch.as_tensor(np.array([x, 0.07, 0.05, 1, 0, 0, 0], np.float32), device=dev)) for x in (-0.165, 0.165)
        )

    def _initialize_episode(self, env_idx: torch.Tensor, options: dict):
        self.agent.reset(self._hug_qpos)
        rng = self._batched_episode_rng
        x = rng.uniform(-0.05, 0.2, ()) - 0.1
        y = rng.uniform(-0.05, 0.05, ()) - 0.37
        xyz = torch.stack([x, y, torch.full_like(x, 0.7508)], -1)
        yaw = rng.uniform(0.0, np.pi / 6, ())
        zero = torch.zeros_like(yaw)
        quat = torch.stack([torch.cos(yaw / 2), zero, zero, torch.sin(yaw / 2)], -1)
        self.box.set_pose(Pose.create_from_pq(xyz, quat))

    @property
    def box_right_grasp_point(self):
        return self.box.pose * self._right_grasp_local

    @property
    def box_left_grasp_point(self):
        return self.box.pose * self._left_grasp_local

    def _hand_contact_force(self, side):
        links = self.agent.robot.links_map
        return sum(
            self.scene.get_pairwise_contact_forces(links[f"{side}_{name}_link"], self.box)
            for name in ("five", "three", "palm")
        )

    def evaluate(self):
        l_forces = torch.sum(torch.abs(self._hand_contact_force("left")), 1)
        r_forces = torch.sum(torch.abs(self._hand_contact_force("right")), 1)
        # a hug grip: both hands press the box with the tcps below the side
        # grasp points
        box_grasped = (
            (l_forces > 10)
            & (r_forces > 10)
            & (self.agent.right_tcp.pose.p[:, 2] < self.box_right_grasp_point.p[:, 2] + 0.04)
            & (self.agent.left_tcp.pose.p[:, 2] < self.box_left_grasp_point.p[:, 2] + 0.04)
        )
        p = self.box.pose.p
        # resting on the table top: centre z = table top + box half = 0.7506
        box_at_correct_table_z = (0.751 > p[:, 2]) & (p[:, 2] > 0.750)
        box_at_correct_table_xy = (0.78 > p[:, 0]) & (p[:, 0] > -0.78) & (1.0 > p[:, 1]) & (p[:, 1] > 0.3)
        torso_yaw = self.agent.robot.qpos[:, self._torso_idx]
        return {
            "success": ~box_grasped & box_at_correct_table_z & box_at_correct_table_xy,
            "left_hand_hit_box": l_forces > 0,
            "right_hand_hit_box": r_forces > 0,
            "box_grasped": box_grasped,
            "box_at_correct_table_xy": box_at_correct_table_xy,
            "facing_table_with_box": (-1.7 < torso_yaw) & (torso_yaw < -1.4),
        }

    def _get_obs_extra(self, info: dict):
        obs = dict(
            right_tcp_pose=self.agent.right_tcp.pose.raw_pose,
            left_tcp_pose=self.agent.left_tcp.pose.raw_pose,
        )
        if "state" in self.obs_mode:
            obs.update(
                box_pose=self.box.pose.raw_pose,
                right_tcp_to_box_pos=self.box.pose.p - self.agent.right_tcp.pose.p,
                left_tcp_to_box_pos=self.box.pose.p - self.agent.left_tcp.pose.p,
            )
        return obs

    def compute_dense_reward(self, obs, action, info):
        q = self.agent.robot.qpos
        torso_yaw = q[:, self._torso_idx]
        l_roll = q[:, self._l_roll_idx]
        r_roll = q[:, self._r_roll_idx]
        # stage 1: turn the torso toward the box's table (yaw -> -1.4)
        reward = 1 - torch.tanh(torch.abs(torso_yaw + 1.4))
        # stage 2: the arms down around the box, the tcps to the grasp points
        right_d = torch.linalg.vector_norm(self.agent.right_tcp.pose.p - self.box_right_grasp_point.p, dim=1)
        left_d = torch.linalg.vector_norm(self.agent.left_tcp.pose.p - self.box_left_grasp_point.p, dim=1)
        stage_2 = (
            1
            + (1 - torch.tanh(torch.abs(l_roll))) / 4
            + (1 - torch.tanh(torch.abs(r_roll))) / 4
            + (1 - torch.tanh(3 * right_d)) / 4
            + (1 - torch.tanh(3 * left_d)) / 4
        )
        reward = torch.where(info["facing_table_with_box"], stage_2, reward)
        # stage 3: twist toward the target table (yaw -> +1.4)
        stage_3 = 2 + 1 - torch.tanh(torch.abs(torso_yaw - 1.4) / 5)
        reward = torch.where(info["box_grasped"], stage_3, reward)
        # stage 4: spread the arms back out to release
        stage_4 = 3 + (1 - torch.tanh(torch.abs(l_roll - 1.25))) / 2 + (1 - torch.tanh(torch.abs(r_roll + 1.25))) / 2
        reward = torch.where(info["box_at_correct_table_xy"], stage_4, reward)
        return torch.where(info["success"], 5.0, reward)

    def compute_normalized_dense_reward(self, obs, action, info):
        return self.compute_dense_reward(obs, action, info) / 5
