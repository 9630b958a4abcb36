"""TwoRobotStackCube-v1 (counterpart of
maniskill_tpu/envs/tasks/tabletop/two_robot_stack_cube.py).

Two Panda arms cooperate to stack: the green cube spawns on the left arm's
side, the blue one on the right arm's. Success = green on blue, released
by both arms, and still.
"""
from __future__ import annotations

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
from .two_robot_pick_cube import LEFT_ROBOT_POSE, RIGHT_ROBOT_POSE


@register_env("TwoRobotStackCube-v1", max_episode_steps=100)
class TwoRobotStackCubeEnv(BaseEnv):
    SUPPORTED_ROBOTS = [("panda", "panda")]
    cube_half_size = 0.02

    def __init__(self, *args, robot_uids=("panda", "panda"), robot_init_qpos_noise=0.02, **kwargs):
        self.robot_init_qpos_noise = robot_init_qpos_noise
        super().__init__(*args, robot_uids=robot_uids, **kwargs)

    @property
    def _default_sensor_configs(self):
        pose = look_at([1.0, 0, 0.75], [0.0, 0.0, 0.25])
        return [CameraConfig("base_camera", pose, 128, 128, np.pi / 2, 0.01, 100)]

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at([1.4, 0.8, 0.75], [0.0, 0.1, 0.1])
        return CameraConfig("render_camera", pose, 512, 512, 1, 0.01, 100)

    def _load_agent(self, options: dict):
        super()._load_agent(options, initial_agent_poses=[LEFT_ROBOT_POSE, RIGHT_ROBOT_POSE])

    @property
    def left_agent(self):
        return self.agent.agents[0]

    @property
    def right_agent(self):
        return self.agent.agents[1]

    def _load_scene(self, options: dict):
        self.table_scene = TableSceneBuilder(self, robot_init_qpos_noise=self.robot_init_qpos_noise)
        self.table_scene.build()
        self.cubeA = actors.build_cube(
            self.scene, half_size=self.cube_half_size, color=[0, 1, 0, 1],
            name="cubeA", initial_pose=np.array([0, -0.2, 0.02, 1, 0, 0, 0]),
        )
        self.cubeB = actors.build_cube(
            self.scene, half_size=self.cube_half_size, color=[0, 0, 1, 1],
            name="cubeB", initial_pose=np.array([0, 0.2, 0.02, 1, 0, 0, 0]),
        )
        self._lift = torch.tensor([0.0, 0.0, 2 * self.cube_half_size], device=self.device)

    def _initialize_episode(self, env_idx: torch.Tensor, options: dict):
        self.table_scene.initialize(env_idx)
        rng = self._batched_episode_rng
        h = self.cube_half_size
        # the green cube on the left half, the blue one on the right half
        ax, ay = rng.uniform(-0.05, 0.05), rng.uniform(-0.2, -0.1)
        xyz = torch.stack([ax, ay, torch.full_like(ax, h)], -1)
        self.cubeA.set_pose(Pose.create_from_pq(xyz, rng.quaternions(lock_x=True, lock_y=True)))
        bx, by = rng.uniform(-0.05, 0.05), rng.uniform(0.1, 0.2)
        xyz = torch.stack([bx, by, torch.full_like(bx, h)], -1)
        self.cubeB.set_pose(Pose.create_from_pq(xyz, rng.quaternions(lock_x=True, lock_y=True)))

    def evaluate(self):
        offset = self.cubeA.pose.p - self.cubeB.pose.p
        xy_ok = torch.linalg.vector_norm(offset[..., :2], dim=-1) <= 0.005 + 2e-3
        z_ok = torch.abs(offset[..., 2] - 2 * self.cube_half_size) <= 5e-3
        is_on = xy_ok & z_ok
        is_grasped = self.left_agent.is_grasping(self.cubeA) | self.right_agent.is_grasping(self.cubeA)
        static = torch.linalg.vector_norm(self.cubeA.linear_velocity, dim=-1) <= 0.05
        return dict(success=is_on & static & ~is_grasped, is_cubeA_on_cubeB=is_on, is_cubeA_grasped=is_grasped)

    def _get_obs_extra(self, info: dict):
        obs = dict(
            left_tcp_pose=self.left_agent.tcp.pose.raw_pose,
            right_tcp_pose=self.right_agent.tcp.pose.raw_pose,
        )
        if parse_obs_mode_to_struct(self.obs_mode)["use_state"]:
            obs.update(
                cubeA_pose=self.cubeA.pose.raw_pose,
                cubeB_pose=self.cubeB.pose.raw_pose,
                cubeA_to_cubeB=self.cubeB.pose.p - self.cubeA.pose.p,
            )
        return obs

    def compute_dense_reward(self, obs, action, info):
        # staged: the left arm reaches A, A approaches the top of B, stacked
        tcp_to_a = torch.linalg.vector_norm(self.cubeA.pose.p - self.left_agent.tcp.pose.p, dim=-1)
        a_to_goal = torch.linalg.vector_norm(self.cubeB.pose.p + self._lift - self.cubeA.pose.p, dim=-1)
        reward = 1 - torch.tanh(5 * tcp_to_a) + 2 * (1 - torch.tanh(5 * a_to_goal))
        reward = torch.where(info["is_cubeA_on_cubeB"], reward + 2, reward)
        return torch.where(info["success"], 8.0, reward)

    def compute_normalized_dense_reward(self, obs, action, info):
        return self.compute_dense_reward(obs, action, info) / 8.0
