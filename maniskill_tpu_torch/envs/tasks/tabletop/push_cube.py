"""PushCube-v1 (counterpart of maniskill_tpu/envs/tasks/tabletop/push_cube.py).

A cube spawns with its xy in [-0.1, 0.1]^2; a red/white target lies flat on
the table 0.1 + goal_radius ahead of it in x; success = the cube's xy within
goal_radius of the target's and the cube still on the table; staged dense
reward reach -> place -> keep z.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ....building import actors
from ....scene_builder.table import TableSceneBuilder
from ....sensors.camera import CameraConfig
from ....structs.pose import Pose
from ....utils.registration import register_env
from ....utils.scene_utils import look_at
from ...base_env import BaseEnv
from ...utils.observations import parse_obs_mode_to_struct


@register_env("PushCube-v1", max_episode_steps=50)
class PushCubeEnv(BaseEnv):
    SUPPORTED_ROBOTS = ["panda"]

    goal_radius = 0.1
    cube_half_size = 0.02

    def __init__(self, *args, robot_uids="panda", robot_init_qpos_noise=0.02, **kwargs):
        self.robot_init_qpos_noise = robot_init_qpos_noise
        super().__init__(*args, robot_uids=robot_uids, **kwargs)

    @property
    def _default_sensor_configs(self):
        pose = look_at(eye=[0.3, 0, 0.6], target=[-0.1, 0, 0.1])
        return [CameraConfig("base_camera", pose, 128, 128, np.pi / 2, 0.01, 100)]

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at([0.6, 0.7, 0.6], [0.0, 0.0, 0.35])
        return CameraConfig("render_camera", pose, 512, 512, 1, 0.01, 100)

    def _load_agent(self, options: dict):
        super()._load_agent(options, np.array([-0.615, 0, 0, 1, 0, 0, 0]))

    def _load_scene(self, options: dict):
        self.table_scene = TableSceneBuilder(self, robot_init_qpos_noise=self.robot_init_qpos_noise)
        self.table_scene.build()
        self.obj = actors.build_cube(
            self.scene,
            half_size=self.cube_half_size,
            color=np.array([12, 42, 160, 255]) / 255,
            name="cube",
            body_type="dynamic",
            initial_pose=np.array([0, 0, self.cube_half_size, 1, 0, 0, 0]),
        )
        self.goal_region = actors.build_red_white_target(
            self.scene,
            radius=self.goal_radius,
            thickness=1e-5,
            name="goal_region",
            add_collision=False,
            body_type="kinematic",
            initial_pose=np.array([0, 0, 1e-3, 1, 0, 0, 0]),
        )
        dev = self.device
        # the target's offset from the cube, and its pose facing up (a pitch
        # of pi/2, as euler2quat(0, pi/2, 0) gives it)
        self._goal_offset = torch.tensor([0.1 + self.goal_radius, 0.0, 0.0], device=dev)
        half = np.float32(math.pi / 2) * np.float32(0.5)
        self._goal_quat = torch.tensor([np.cos(half), 0.0, np.sin(half), 0.0], dtype=torch.float32, device=dev)
        self._cube_quat = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
        self._push_offset = torch.tensor([-self.cube_half_size - 0.005, 0.0, 0.0], device=dev)

    def _initialize_episode(self, env_idx: torch.Tensor, options: dict):
        self.table_scene.initialize(env_idx)
        xy = self._batched_episode_rng.uniform(-0.1, 0.1, (2,))
        xyz = torch.cat([xy, torch.full_like(xy[:, :1], self.cube_half_size)], -1)
        self.obj.set_pose(Pose(torch.cat([xyz, self._cube_quat.expand(self.num_envs, 4)], -1)))

        target = xyz + self._goal_offset
        target = torch.cat([target[:, :2], torch.full_like(target[:, 2:], 1e-3)], -1)
        self.goal_region.set_pose(Pose(torch.cat([target, self._goal_quat.expand(self.num_envs, 4)], -1)))

    def evaluate(self):
        p = self.obj.pose.p
        is_obj_placed = (
            torch.linalg.vector_norm(p[..., :2] - self.goal_region.pose.p[..., :2], dim=1)
            < self.goal_radius
        ) & (p[..., 2] < self.cube_half_size + 5e-3)
        return {"success": is_obj_placed}

    def _get_obs_extra(self, info: dict):
        obs = dict(tcp_pose=self.agent.tcp.pose.raw_pose)
        if parse_obs_mode_to_struct(self.obs_mode)["use_state"]:
            obs.update(goal_pos=self.goal_region.pose.p, obj_pose=self.obj.pose.raw_pose)
        return obs

    def compute_dense_reward(self, obs, action, info):
        tcp_to_push = self.obj.pose.p + self._push_offset - self.agent.tcp.pose.p
        tcp_to_push_dist = torch.linalg.vector_norm(tcp_to_push, dim=1)
        reward = 1 - torch.tanh(5 * tcp_to_push_dist)

        reached = (tcp_to_push_dist < 0.01).to(torch.float32)
        obj_to_goal_dist = torch.linalg.vector_norm(
            self.obj.pose.p[..., :2] - self.goal_region.pose.p[..., :2], dim=1
        )
        place_reward = 1 - torch.tanh(5 * obj_to_goal_dist)
        reward = reward + place_reward * reached

        z_reward = 1 - torch.tanh(5 * torch.abs(self.obj.pose.p[..., 2] - self.cube_half_size))
        reward = reward + place_reward * z_reward * reached
        return torch.where(info["success"], 3.0, reward)

    def compute_normalized_dense_reward(self, obs, action, info):
        return self.compute_dense_reward(obs=obs, action=action, info=info) / 3.0
