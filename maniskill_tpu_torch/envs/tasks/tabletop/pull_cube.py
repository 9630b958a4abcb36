"""PullCube-v1 (counterpart of maniskill_tpu/envs/tasks/tabletop/pull_cube.py).

Pull the cube back onto a red/white target that lies 0.1 + goal_radius
behind it (toward the robot); success = the cube's xy within goal_radius of
the target's; staged dense reward reach the cube's far side -> pull.
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


@register_env("PullCube-v1", max_episode_steps=50)
class PullCubeEnv(BaseEnv):
    SUPPORTED_ROBOTS = ["panda"]
    goal_radius = 0.1
    cube_half_size = 0.02

    def __init__(self, *args, robot_uids="panda", robot_init_qpos_noise=0.02, **kwargs):
        self.robot_init_qpos_noise = robot_init_qpos_noise
        super().__init__(*args, robot_uids=robot_uids, **kwargs)

    @property
    def _default_sensor_configs(self):
        pose = look_at(eye=[-0.5, 0.0, 0.25], target=[0.2, 0.0, -0.5])
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
            self.scene, half_size=self.cube_half_size,
            color=np.array([12, 42, 160, 255]) / 255, name="cube",
            body_type="dynamic",
            initial_pose=np.array([0, 0, self.cube_half_size, 1, 0, 0, 0]),
        )
        self.goal_region = actors.build_red_white_target(
            self.scene, radius=self.goal_radius, thickness=1e-5,
            name="goal_region", add_collision=False, body_type="kinematic",
            initial_pose=np.array([0, 0, 1e-3, 1, 0, 0, 0]),
        )
        dev = self.device
        self._goal_offset = torch.tensor([-(0.1 + self.goal_radius), 0.0, 0.0], device=dev)
        # the target faces up: a pitch of pi/2, as euler2quat(0, pi/2, 0)
        half = np.float32(math.pi / 2) * np.float32(0.5)
        self._goal_quat = torch.tensor([np.cos(half), 0.0, np.sin(half), 0.0], dtype=torch.float32, device=dev)
        self._cube_quat = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
        self._pull_offset = torch.tensor([self.cube_half_size + 2 * 0.005, 0.0, 0.0], device=dev)

    def _initialize_episode(self, env_idx: torch.Tensor, options: dict):
        self.table_scene.initialize(env_idx)
        xy = self._batched_episode_rng.uniform(-0.1, 0.1, (2,))
        xyz = torch.cat([xy, torch.full_like(xy[:, :1], self.cube_half_size)], -1)
        self.obj.set_pose(Pose.create_from_pq(xyz, self._cube_quat))
        target = xyz + self._goal_offset
        target = torch.cat([target[:, :2], torch.full_like(target[:, 2:], 1e-3)], -1)
        self.goal_region.set_pose(Pose.create_from_pq(target, self._goal_quat))

    def evaluate(self):
        d = torch.linalg.vector_norm(self.obj.pose.p[..., :2] - self.goal_region.pose.p[..., :2], dim=1)
        return {"success": d < self.goal_radius}

    def _get_obs_extra(self, info: dict):
        obs = dict(tcp_pose=self.agent.tcp.pose.raw_pose, goal_pos=self.goal_region.pose.p)
        if parse_obs_mode_to_struct(self.obs_mode)["use_state"]:
            obs.update(obj_pose=self.obj.pose.raw_pose)
        return obs

    def compute_dense_reward(self, obs, action, info):
        tcp_to_pull = self.obj.pose.p + self._pull_offset - self.agent.tcp.pose.p
        dist = torch.linalg.vector_norm(tcp_to_pull, dim=1)
        reward = 1 - torch.tanh(5 * dist)
        reached = (dist < 0.01).to(torch.float32)
        obj_to_goal = torch.linalg.vector_norm(
            self.obj.pose.p[..., :2] - self.goal_region.pose.p[..., :2], dim=1
        )
        reward = reward + (1 - torch.tanh(5 * obj_to_goal)) * reached
        return torch.where(info["success"], 3.0, reward)

    def compute_normalized_dense_reward(self, obs, action, info):
        return self.compute_dense_reward(obs, action, info) / 3.0
