"""LiftPegUpright-v1 (counterpart of
maniskill_tpu/envs/tasks/tabletop/lift_peg_upright.py).

A box peg lies on the table along y; stand it upright. Success = the peg's
long axis vertical within 0.08 rad and its centre at half its length above
the table; dense reward for verticality, height and reaching.
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


@register_env("LiftPegUpright-v1", max_episode_steps=50)
class LiftPegUprightEnv(BaseEnv):
    SUPPORTED_ROBOTS = ["panda"]
    peg_half_width = 0.025
    peg_half_length = 0.12

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
        self.peg = actors.build_twocolor_peg(
            self.scene, length=self.peg_half_length, width=self.peg_half_width,
            color_1=np.array([176, 14, 14, 255]) / 255,
            color_2=np.array([12, 42, 160, 255]) / 255,
            name="peg", body_type="dynamic",
            initial_pose=np.array([0, 0, 0.1, 1, 0, 0, 0]),
        )
        # lying along y: a roll of pi/2, as euler2quat(pi/2, 0, 0)
        half = np.float32(math.pi / 2) * np.float32(0.5)
        self._peg_quat = torch.tensor([np.cos(half), np.sin(half), 0.0, 0.0], dtype=torch.float32, device=self.device)

    def _initialize_episode(self, env_idx: torch.Tensor, options: dict):
        self.table_scene.initialize(env_idx)
        xy = self._batched_episode_rng.uniform(-0.1, 0.1, (2,))
        xyz = torch.cat([xy, torch.full_like(xy[:, :1], self.peg_half_width)], -1)
        self.peg.set_pose(Pose.create_from_pq(xyz, self._peg_quat))

    def evaluate(self):
        euler = rc.matrix_to_euler_angles(rc.quaternion_to_matrix(self.peg.pose.q), "XYZ")
        is_peg_upright = torch.abs(torch.abs(euler[:, 2]) - np.pi / 2) < 0.08
        close_to_table = torch.abs(self.peg.pose.p[:, 2] - self.peg_half_length) < 0.005
        return {"success": is_peg_upright & close_to_table}

    def _get_obs_extra(self, info: dict):
        obs = dict(tcp_pose=self.agent.tcp.pose.raw_pose)
        if parse_obs_mode_to_struct(self.obs_mode)["use_state"]:
            obs.update(obj_pose=self.peg.pose.raw_pose)
        return obs

    def compute_dense_reward(self, obs, action, info):
        rot_vec = rc.quaternion_to_matrix(self.peg.pose.q)[..., :, 0]  # the peg's +x in the world
        reward = torch.abs(rot_vec[..., 2])
        z_dist = torch.abs(self.peg.pose.p[:, 2] - self.peg_half_length)
        reward = reward + 1 - torch.tanh(5 * z_dist)
        to_grip = self.peg.pose.p - self.agent.tcp.pose.p
        reaching = 1 - torch.tanh(5 * torch.linalg.vector_norm(to_grip, dim=1))
        reaching = torch.where(self.agent.is_grasping(self.peg), 1.0, reaching)
        reward = reward + reaching / 5
        return torch.where(info["success"], 3.0, reward)

    def compute_normalized_dense_reward(self, obs, action, info):
        return self.compute_dense_reward(obs, action, info) / 3.0
