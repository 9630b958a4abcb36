"""TwoRobotPickCube-v1 (counterpart of
maniskill_tpu/envs/tasks/tabletop/two_robot_pick_cube.py).

Two Panda arms face each other across the table. The cube spawns where
only the left arm reaches and the goal floats where only the right arm
reaches, so the left arm must hand the cube over. Success = the cube
within ``goal_thresh`` of the goal and the right arm static; staged dense
reward: left reach -> hand-over progress -> right reach -> to the goal.
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

# the left robot at -y facing +y, the right one at +y facing -y
LEFT_ROBOT_POSE = np.array([0, -0.75, 0, 0.7071068, 0, 0, 0.7071068])
RIGHT_ROBOT_POSE = np.array([0, 0.75, 0, 0.7071068, 0, 0, -0.7071068])


@register_env("TwoRobotPickCube-v1", max_episode_steps=100)
class TwoRobotPickCubeEnv(BaseEnv):
    SUPPORTED_ROBOTS = [("panda", "panda")]
    cube_half_size = 0.02
    goal_thresh = 0.025

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
        self.cube = actors.build_cube(
            self.scene, half_size=self.cube_half_size, color=[1, 0, 0, 1],
            name="cube", initial_pose=np.array([0, -0.2, 0.02, 1, 0, 0, 0]),
        )
        self.goal_site = actors.build_sphere(
            self.scene, radius=self.goal_thresh, color=[0, 1, 0, 1],
            name="goal_site", body_type="kinematic", add_collision=False,
            initial_pose=np.array([0, 0.2, 0.2, 1, 0, 0, 0]),
        )
        self._hidden_objects.append(self.goal_site)
        self._identity_q = torch.tensor([1.0, 0.0, 0.0, 0.0], device=self.device)

    def _initialize_episode(self, env_idx: torch.Tensor, options: dict):
        self.table_scene.initialize(env_idx)
        rng = self._batched_episode_rng
        # the cube on the left half, in reach of the left robot only
        x = rng.uniform(-0.05, 0.05)
        y = -0.15 - rng.uniform(0.0, 0.1) + 0.05
        xyz = torch.stack([x, y, torch.full_like(x, self.cube_half_size)], -1)
        self.cube.set_pose(Pose.create_from_pq(xyz, rng.quaternions(lock_x=True, lock_y=True)))
        # the goal in the air on the right half
        gx = rng.uniform(-0.05, 0.05)
        gy = 0.1 + rng.uniform(0.0, 0.1)
        gz = rng.uniform(0.15, 0.35)
        self.goal_site.set_pose(Pose.create_from_pq(torch.stack([gx, gy, gz], -1), self._identity_q))

    def evaluate(self):
        is_placed = (
            torch.linalg.vector_norm(self.goal_site.pose.p - self.cube.pose.p, dim=1) <= self.goal_thresh
        )
        return {"success": is_placed & self.right_agent.is_static(0.2), "is_obj_placed": is_placed}

    def _get_obs_extra(self, info: dict):
        left_p, right_p = self.left_agent.tcp.pose, self.right_agent.tcp.pose
        obs = dict(
            left_tcp_pose=left_p.raw_pose,
            right_tcp_pose=right_p.raw_pose,
            goal_pos=self.goal_site.pose.p,
        )
        if parse_obs_mode_to_struct(self.obs_mode)["use_state"]:
            cube_p = self.cube.pose.p
            obs.update(
                cube_pose=self.cube.pose.raw_pose,
                left_tcp_to_cube=cube_p - left_p.p,
                right_tcp_to_cube=cube_p - right_p.p,
                cube_to_goal=self.goal_site.pose.p - cube_p,
            )
        return obs

    def compute_dense_reward(self, obs, action, info):
        cube_p = self.cube.pose.p
        # stage 1: the left arm reaches the cube
        l_dist = torch.linalg.vector_norm(cube_p - self.left_agent.tcp.pose.p, dim=1)
        reward = 1 - torch.tanh(5 * l_dist)
        # stage 2: the cube moves toward the centre and the right (hand-over)
        reward = reward + torch.clamp((cube_p[:, 1] + 0.2) / 0.4, 0.0, 1.0)
        # stage 3: the right arm reaches the cube once it is on the right half
        r_dist = torch.linalg.vector_norm(cube_p - self.right_agent.tcp.pose.p, dim=1)
        right_side = cube_p[:, 1] > 0.0
        reward = reward + (1 - torch.tanh(5 * r_dist)) * right_side
        # stage 4: the cube to the goal
        goal_dist = torch.linalg.vector_norm(self.goal_site.pose.p - cube_p, dim=1)
        reward = reward + (1 - torch.tanh(5 * goal_dist)) * right_side
        return torch.where(info["success"], 6.0, reward)

    def compute_normalized_dense_reward(self, obs, action, info):
        return self.compute_dense_reward(obs, action, info) / 6.0
