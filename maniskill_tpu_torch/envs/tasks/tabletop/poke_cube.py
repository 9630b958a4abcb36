"""PokeCube-v1 (counterpart of
maniskill_tpu/envs/tasks/tabletop/poke_cube.py).

Grasp a peg and use it to poke a cube onto a goal region. Success = the
cube's xy within the goal radius and the robot static; staged dense reward
reach the peg -> grasp and align its head with the cube -> push to the goal.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ....building import actors
from ....scene_builder.table import TableSceneBuilder
from ....sensors.camera import CameraConfig
from ....structs.pose import Pose
from ....utils.geometry import rotation_conversions as rc
from ....utils.registration import register_env
from ....utils.scene_utils import look_at
from ...base_env import BaseEnv
from ...utils.observations import parse_obs_mode_to_struct


@register_env("PokeCube-v1", max_episode_steps=50)
class PokeCubeEnv(BaseEnv):
    SUPPORTED_ROBOTS = ["panda"]
    cube_half_size = 0.02
    peg_half_width = 0.025
    peg_half_length = 0.12
    goal_radius = 0.05

    def __init__(self, *args, robot_uids="panda", robot_init_qpos_noise=0.02, **kwargs):
        self.robot_init_qpos_noise = robot_init_qpos_noise
        super().__init__(*args, robot_uids=robot_uids, **kwargs)

    @property
    def _default_sensor_configs(self):
        pose = look_at(eye=[0.3, 0, 0.6], target=[-0.1, 0, 0.1])
        return [CameraConfig("base_camera", pose, 128, 128, np.pi / 2, 0.01, 100)]

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at([0.6, 0.7, 0.6], [0.2, 0.2, 0.35])
        return CameraConfig("render_camera", pose, 512, 512, 1, 0.01, 100)

    def _load_agent(self, options: dict):
        super()._load_agent(options, np.array([-0.615, 0, 0, 1, 0, 0, 0]))

    def _load_scene(self, options: dict):
        self.table_scene = TableSceneBuilder(self, robot_init_qpos_noise=self.robot_init_qpos_noise)
        self.table_scene.build()
        self.cube = actors.build_cube(
            self.scene, half_size=self.cube_half_size, color=[1, 0, 0, 1],
            name="cube", body_type="dynamic",
            initial_pose=np.array([0.3, 0, self.cube_half_size, 1, 0, 0, 0]),
        )
        self.peg = actors.build_twocolor_peg(
            self.scene, length=self.peg_half_length, width=self.peg_half_width,
            color_1=np.array([12, 42, 160, 255]) / 255,
            color_2=np.array([12, 42, 160, 255]) / 255,
            name="peg", body_type="dynamic",
            initial_pose=np.array([0, 0, self.peg_half_width, 1, 0, 0, 0]),
        )
        self.goal_region = actors.build_red_white_target(
            self.scene, radius=self.goal_radius, thickness=1e-5,
            name="goal_region", add_collision=False, body_type="kinematic",
            initial_pose=np.array([0, 0, 1e-3, 1, 0, 0, 0]),
        )
        dev = self.device
        self.peg_head_offset = torch.tensor([self.peg_half_length, 0.0, 0.0], device=dev)
        self._identity_q = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
        self._goal_offset = torch.tensor([0.05 + self.goal_radius, 0.0, 0.0], device=dev)
        # the target faces up: a pitch of pi/2, as euler2quat(0, pi/2, 0)
        half = np.float32(math.pi / 2) * np.float32(0.5)
        self._goal_quat = torch.tensor([np.cos(half), 0.0, np.sin(half), 0.0], dtype=torch.float32, device=dev)

    @property
    def peg_head_pos(self):
        return self.peg.pose.p + rc.quaternion_apply(self.peg.pose.q, self.peg_head_offset)

    @property
    def peg_head_pose(self):
        return self.peg.pose * Pose.create_from_pq(self.peg_head_offset, self._identity_q)

    def _initialize_episode(self, env_idx: torch.Tensor, options: dict):
        self.table_scene.initialize(env_idx)
        rng = self._batched_episode_rng
        peg_xy = rng.uniform(-0.1, 0.1, (2,))
        peg_xyz = torch.cat([peg_xy, torch.full_like(peg_xy[:, :1], self.peg_half_width)], -1)
        self.peg.set_pose(Pose.create_from_pq(peg_xyz, self._identity_q))

        cube_y = rng.uniform(-0.1, 0.1)
        cube_x = peg_xyz[:, 0] + self.peg_half_length + 0.1
        cube_xyz = torch.stack([cube_x, cube_y, torch.full_like(cube_x, self.cube_half_size)], -1)
        ang = rng.uniform(-np.pi / 6, np.pi / 6)
        zeros = torch.zeros_like(ang)
        cube_q = rc.axis_angle_to_quaternion(torch.stack([zeros, zeros, ang], -1))
        self.cube.set_pose(Pose.create_from_pq(cube_xyz, cube_q))

        goal_xyz = cube_xyz + self._goal_offset
        goal_xyz = torch.cat([goal_xyz[:, :2], torch.full_like(goal_xyz[:, 2:], 1e-3)], -1)
        self.goal_region.set_pose(Pose.create_from_pq(goal_xyz, self._goal_quat))

    def evaluate(self):
        cube_p = self.cube.pose.p
        is_cube_placed = (
            torch.linalg.vector_norm(cube_p[..., :2] - self.goal_region.pose.p[..., :2], dim=1) < self.goal_radius
        )
        peg_euler = rc.matrix_to_euler_angles(rc.quaternion_to_matrix(self.peg_head_pose.q), "XYZ")
        cube_euler = rc.matrix_to_euler_angles(rc.quaternion_to_matrix(self.cube.pose.q), "XYZ")
        angle_diff = torch.abs(peg_euler[:, 2] - cube_euler[:, 2])
        is_peg_cube_aligned = angle_diff < 0.05
        head_to_cube_dist = torch.linalg.vector_norm(self.peg_head_pos[..., :2] - cube_p[..., :2], dim=1)
        is_peg_cube_close = head_to_cube_dist <= self.cube_half_size + 0.005
        return {
            "success": is_cube_placed & self.agent.is_static(0.2),
            "is_cube_placed": is_cube_placed,
            "is_peg_cube_fit": is_peg_cube_aligned & is_peg_cube_close,
            "is_peg_grasped": self.agent.is_grasping(self.peg),
            "angle_diff": angle_diff,
            "head_to_cube_dist": head_to_cube_dist,
        }

    def _get_obs_extra(self, info: dict):
        obs = dict(tcp_pose=self.agent.tcp.pose.raw_pose)
        if parse_obs_mode_to_struct(self.obs_mode)["use_state"]:
            tcp_p, peg_p, cube_p, goal_p = (self.agent.tcp.pose.p, self.peg.pose.p, self.cube.pose.p,
                                            self.goal_region.pose.p)
            obs.update(
                cube_pose=self.cube.pose.raw_pose,
                peg_pose=self.peg.pose.raw_pose,
                goal_pos=goal_p,
                tcp_to_peg_pos=peg_p - tcp_p,
                peg_to_cube_pos=cube_p - peg_p,
                cube_to_goal_pos=goal_p - cube_p,
                peghead_to_cube_pos=self.peg_head_pos - cube_p,
            )
        return obs

    def compute_dense_reward(self, obs, action, info):
        tcp_to_peg_dist = torch.linalg.vector_norm(self.agent.tcp.pose.p - self.peg.pose.p, dim=1)
        reached = tcp_to_peg_dist < 0.01
        reward = 2 * (1 - torch.tanh(5.0 * tcp_to_peg_dist))

        align_reward = 1 - torch.tanh(5.0 * info["angle_diff"])
        close_reward = 1 - torch.tanh(5.0 * info["head_to_cube_dist"])
        is_peg_grasped = info["is_peg_grasped"] & reached
        reward = torch.where(is_peg_grasped, 4 + close_reward + align_reward, reward)

        cube_to_goal_dist = torch.linalg.vector_norm(self.goal_region.pose.p - self.cube.pose.p, dim=1)
        place_reward = 1 - torch.tanh(5 * cube_to_goal_dist)
        is_fit = info["is_peg_cube_fit"] & is_peg_grasped
        reward = torch.where(is_fit, 7 + place_reward, reward)

        static_reward = 1 - torch.tanh(5 * torch.linalg.vector_norm(self.agent.robot.qvel[..., :-2], dim=1))
        reward = reward + static_reward * info["is_cube_placed"]
        return torch.where(info["success"], 10.0, reward)

    def compute_normalized_dense_reward(self, obs, action, info):
        return self.compute_dense_reward(obs, action, info) / 10.0
