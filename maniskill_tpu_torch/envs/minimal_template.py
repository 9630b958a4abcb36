"""Minimal task template (counterpart of maniskill_tpu/envs/minimal_template.py).

Copy this file to start a new task: define scene loading, per-episode
initialization, success evaluation, observations and rewards. It is not
registered (the JAX package leaves its registration commented out too):
construct ``MyTaskEnv`` directly.
"""
from __future__ import annotations

import numpy as np
import torch

from ..building import actors
from ..scene_builder.table import TableSceneBuilder
from ..sensors.camera import CameraConfig
from ..structs.pose import Pose
from ..utils.scene_utils import look_at
from .base_env import BaseEnv


# @register_env("MyTask-v1", max_episode_steps=50)
class MyTaskEnv(BaseEnv):
    SUPPORTED_ROBOTS = ["panda"]

    def __init__(self, *args, robot_uids="panda", **kwargs):
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
        # the static scene and any dynamic objects, built once per reconfigure
        self.table_scene = TableSceneBuilder(env=self)
        self.table_scene.build()
        self.obj = actors.build_cube(
            self.scene, half_size=0.02, color=[1, 0, 0, 1], name="obj",
            initial_pose=np.array([0, 0, 0.02, 1, 0, 0, 0]),
        )

    def _initialize_episode(self, env_idx: torch.Tensor, options: dict):
        # poses and joint states of the (masked) resetting envs; draws from
        # self._batched_episode_rng are deterministic per env
        self.table_scene.initialize(env_idx)
        xy = self._batched_episode_rng.uniform(-0.1, 0.1, size=(2,))
        xyz = torch.cat([xy, torch.full_like(xy[:, :1], 0.02)], -1)
        q = torch.zeros_like(torch.cat([xy, xy], -1))
        q[:, 0] = 1.0
        self.obj.set_pose(Pose.create_from_pq(xyz, q))

    def evaluate(self):
        return {"success": torch.zeros(self.num_envs, dtype=torch.bool, device=self.device)}

    def _get_obs_extra(self, info: dict):
        return dict(tcp_pose=self.agent.tcp.pose.raw_pose)

    def compute_dense_reward(self, obs, action, info):
        return torch.zeros(self.num_envs, device=self.device)

    def compute_normalized_dense_reward(self, obs, action, info):
        return self.compute_dense_reward(obs, action, info)
