"""RollBall-v1 (counterpart of
maniskill_tpu/envs/tasks/tabletop/roll_ball.py).

Hit a ball so that it rolls into a distant goal region. Success = the
ball's xy within the goal radius. The dense reward's sticky per-env
"reached" flag is a task extra (``reached_status``), kept in the sim state
and cleared on reset.
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


@register_env("RollBall-v1", max_episode_steps=80)
class RollBallEnv(BaseEnv):
    SUPPORTED_ROBOTS = ["panda"]
    ball_radius = 0.035
    goal_radius = 0.1

    def __init__(self, *args, robot_uids="panda", robot_init_qpos_noise=0.02, **kwargs):
        self.robot_init_qpos_noise = robot_init_qpos_noise
        super().__init__(*args, robot_uids=robot_uids, **kwargs)

    @property
    def _default_sensor_configs(self):
        pose = look_at(eye=[0.3, 0, 0.6], target=[-0.1, 0, 0.1])
        return [CameraConfig("base_camera", pose, 128, 128, np.pi / 2, 0.01, 100)]

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at([0.6, 1.3, 0.8], [0.0, 0.13, 0.0])
        return CameraConfig("render_camera", pose, 512, 512, 1, 0.01, 100)

    def _load_agent(self, options: dict):
        # the robot faces the ball across the table
        super()._load_agent(options, np.array([-0.1, 1.0, 0, 0.7071, 0, 0, -0.7072]))

    def _load_scene(self, options: dict):
        self.table_scene = TableSceneBuilder(self, robot_init_qpos_noise=self.robot_init_qpos_noise)
        self.table_scene.build()
        self.ball = actors.build_sphere(
            self.scene, radius=self.ball_radius, color=[0, 0.2, 0.8, 1],
            name="ball", initial_pose=np.array([0, 0.5, 0.1, 1, 0, 0, 0]),
        )
        self.goal_region = actors.build_red_white_target(
            self.scene, radius=self.goal_radius, thickness=1e-5,
            name="goal_region", add_collision=False, body_type="kinematic",
            initial_pose=np.array([0, -0.8, 1e-3, 1, 0, 0, 0]),
        )
        self.scene.register_extra("reached_status")
        dev = self.device
        self._identity_q = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
        # the target faces up: a pitch of pi/2, as euler2quat(0, pi/2, 0)
        half = np.float32(math.pi / 2) * np.float32(0.5)
        self._goal_quat = torch.tensor([np.cos(half), 0.0, np.sin(half), 0.0], dtype=torch.float32, device=dev)

    def _initialize_episode(self, env_idx: torch.Tensor, options: dict):
        self.table_scene.initialize(env_idx)
        rng = self._batched_episode_rng
        x = (rng.uniform(0.0, 1.0) * 2 - 1) * 0.3 - 0.1
        y = rng.uniform(0.0, 1.0) * 0.2 + 0.5
        xyz = torch.stack([x, y, torch.full_like(x, self.ball_radius)], -1)
        self.ball.set_pose(Pose.create_from_pq(xyz, self._identity_q))

        gx = (rng.uniform(0.0, 1.0) * 2 - 1) * 0.3 - 0.1
        gy = rng.uniform(0.0, 1.0) * 0.2 - 1.0 + self.goal_radius
        goal = torch.stack([gx, gy, torch.full_like(gx, 1e-3)], -1)
        self.goal_region.set_pose(Pose.create_from_pq(goal, self._goal_quat))

    def evaluate(self):
        to_goal = self.ball.pose.p[..., :2] - self.goal_region.pose.p[..., :2]
        return {"success": torch.linalg.vector_norm(to_goal, dim=1) < self.goal_radius}

    def _get_obs_extra(self, info: dict):
        obs = dict(tcp_pose=self.agent.tcp.pose.raw_pose)
        if parse_obs_mode_to_struct(self.obs_mode)["use_state"]:
            ball_p, goal_p = self.ball.pose.p, self.goal_region.pose.p
            obs.update(
                goal_pos=goal_p,
                ball_pose=self.ball.pose.raw_pose,
                ball_vel=self.ball.linear_velocity,
                tcp_to_ball_pos=ball_p - self.agent.tcp.pose.p,
                ball_to_goal_pos=goal_p - ball_p,
            )
        return obs

    def compute_dense_reward(self, obs, action, info):
        ball_p, goal_p = self.ball.pose.p, self.goal_region.pose.p
        unit_vec = ball_p - goal_p
        unit_vec = unit_vec / torch.clamp(torch.linalg.vector_norm(unit_vec, dim=1, keepdim=True), min=1e-9)
        hit_p = ball_p + unit_vec * (self.ball_radius + 0.05)
        tcp_to_hit_dist = torch.linalg.vector_norm(hit_p - self.agent.tcp.pose.p, dim=1)
        reached = torch.maximum(self.scene.get_extra("reached_status"), (tcp_to_hit_dist < 0.04).to(torch.float32))
        self.scene.set_extra("reached_status", reached, masked=False)

        reaching_reward = 1 - torch.tanh(2 * tcp_to_hit_dist)
        obj_to_goal = torch.linalg.vector_norm(ball_p[..., :2] - goal_p[..., :2], dim=1)
        reached_reward = 1 - torch.tanh(obj_to_goal)
        reward = 20 * reached_reward * reached + reaching_reward * (1 - reached) + reached
        return torch.where(info["success"], 30.0, reward)

    def compute_normalized_dense_reward(self, obs, action, info):
        return self.compute_dense_reward(obs, action, info) / 30.0
