"""StackCube-v1 (counterpart of maniskill_tpu/envs/tasks/tabletop/stack_cube.py).

Pick the red cube A and stack it on the green cube B, then let go. Both
cubes spawn on the table with random yaws, B at least a cube diagonal from
A; success = A on B, A at rest and not grasped; staged dense reward reach
-> grasp and place -> release and still.
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


@register_env("StackCube-v1", max_episode_steps=50)
class StackCubeEnv(BaseEnv):
    SUPPORTED_ROBOTS = ["panda"]
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
        self.cubeA = actors.build_cube(
            self.scene, half_size=0.02, color=[1, 0, 0, 1], name="cubeA",
            initial_pose=np.array([0, 0, 0.1, 1, 0, 0, 0]),
        )
        self.cubeB = actors.build_cube(
            self.scene, half_size=0.02, color=[0, 1, 0, 1], name="cubeB",
            initial_pose=np.array([0.08, 0, 0.1, 1, 0, 0, 0]),
        )

    def _initialize_episode(self, env_idx: torch.Tensor, options: dict):
        self.table_scene.initialize(env_idx)
        rng = self._batched_episode_rng
        base_xy = rng.uniform(-0.1, 0.1, (2,))
        # B's offset from A: a random direction, at least one cube diagonal
        # away (batched, no rejection loop)
        radius = float(np.linalg.norm([0.02, 0.02])) + 0.001
        angle = rng.uniform(0.0, 2 * math.pi)
        dist = rng.uniform(2 * radius, 0.16)
        offset = torch.stack([torch.cos(angle), torch.sin(angle)], -1) * dist[:, None]
        cubeB_xy = torch.clamp(base_xy + offset, -0.12, 0.12)
        z = torch.full_like(base_xy[:, :1], 0.02)
        qa = rng.quaternions(lock_x=True, lock_y=True)
        self.cubeA.set_pose(Pose.create_from_pq(torch.cat([base_xy, z], -1), qa))
        qb = rng.quaternions(lock_x=True, lock_y=True)
        self.cubeB.set_pose(Pose.create_from_pq(torch.cat([cubeB_xy, z], -1), qb))

    def evaluate(self):
        offset = self.cubeA.pose.p - self.cubeB.pose.p
        xy_flag = torch.linalg.vector_norm(offset[..., :2], dim=1) <= float(np.linalg.norm([0.02, 0.02])) + 0.005
        z_flag = torch.abs(offset[..., 2] - 0.04) <= 0.005
        is_cubeA_on_cubeB = xy_flag & z_flag
        is_cubeA_static = self.cubeA.is_static_check(lin_thresh=1e-2, ang_thresh=0.5)
        is_cubeA_grasped = self.agent.is_grasping(self.cubeA)
        return {
            "is_cubeA_grasped": is_cubeA_grasped,
            "is_cubeA_on_cubeB": is_cubeA_on_cubeB,
            "is_cubeA_static": is_cubeA_static,
            "success": is_cubeA_on_cubeB & is_cubeA_static & ~is_cubeA_grasped,
        }

    def _get_obs_extra(self, info: dict):
        obs = dict(tcp_pose=self.agent.tcp.pose.raw_pose)
        if "state" in self.obs_mode:
            tcp_p = self.agent.tcp.pose.p
            a, b = self.cubeA.pose, self.cubeB.pose
            obs.update(
                cubeA_pose=a.raw_pose,
                cubeB_pose=b.raw_pose,
                tcp_to_cubeA_pos=a.p - tcp_p,
                tcp_to_cubeB_pos=b.p - tcp_p,
                cubeA_to_cubeB_pos=b.p - a.p,
            )
        return obs

    def compute_dense_reward(self, obs, action, info):
        cubeA_pos = self.cubeA.pose.p
        cubeB_pos = self.cubeB.pose.p
        reward = 2 * (1 - torch.tanh(5 * torch.linalg.vector_norm(self.agent.tcp.pose.p - cubeA_pos, dim=1)))

        goal_xyz = torch.cat([cubeB_pos[:, :2], (cubeB_pos[:, 2] + 0.04)[:, None]], -1)
        place_reward = 1 - torch.tanh(5.0 * torch.linalg.vector_norm(goal_xyz - cubeA_pos, dim=1))
        grasped = info["is_cubeA_grasped"]
        reward = torch.where(grasped, 4 + place_reward, reward)

        gripper_width = 0.04 * 2
        ungrasp_reward = torch.sum(self.agent.robot.qpos[:, -2:], 1) / gripper_width
        ungrasp_reward = torch.where(~grasped, 1.0, ungrasp_reward)
        v = torch.linalg.vector_norm(self.cubeA.linear_velocity, dim=1)
        av = torch.linalg.vector_norm(self.cubeA.angular_velocity, dim=1)
        static_reward = 1 - torch.tanh(v * 10 + av)
        reward = torch.where(info["is_cubeA_on_cubeB"], 6 + (ungrasp_reward + static_reward) / 2.0, reward)
        return torch.where(info["success"], 8.0, reward)

    def compute_normalized_dense_reward(self, obs, action, info):
        return self.compute_dense_reward(obs, action, info) / 8.0
