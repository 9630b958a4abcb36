"""FrankaMoveBenchmark-v1 and FrankaPickCubeBenchmark-v1 (counterpart of
maniskill_tpu/envs/tasks/benchmark/franka_benchmarks.py): the Panda on a
ground plane at 100/50 Hz, the envs behind the upstream state-throughput
table."""
from __future__ import annotations

import numpy as np
import torch

from ....building import actors
from ....building.ground import build_ground
from ....sensors.camera import CameraConfig
from ....structs.types import SceneConfig, SimConfig
from ....utils.registration import register_env
from ....utils.scene_utils import look_at
from ...base_env import BaseEnv


class _FrankaBenchmarkBase(BaseEnv):
    SUPPORTED_REWARD_MODES = ("none",)
    # the upstream benchmark envs use 8 (move) and 10 (pick cube) position
    # iterations
    _solver_position_iterations = 8

    def __init__(self, *args, camera_width=128, camera_height=128, num_cameras=1, **kwargs):
        self.camera_width = camera_width
        self.camera_height = camera_height
        self.num_cameras = num_cameras
        kwargs.setdefault("reward_mode", "none")
        super().__init__(*args, robot_uids="panda", **kwargs)

    @property
    def _default_sim_config(self):
        return SimConfig(
            sim_freq=100,
            control_freq=50,
            scene_config=SceneConfig(solver_position_iterations=self._solver_position_iterations),
        )

    @property
    def _default_sensor_configs(self):
        pose = look_at(eye=[-0.4, 0, 1.0], target=[0.55, 0, 0.48])
        return [
            CameraConfig(f"base_camera_{i}", pose, self.camera_width, self.camera_height, fov=0.63, far=25)
            for i in range(self.num_cameras or 0)
        ]

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at(eye=[-0.4, 0, 1.0], target=[0.55, 0, 0.48])
        return CameraConfig("render_camera", pose, 512, 512, fov=0.63, far=25)

    def evaluate(self):
        return {}

    def _get_obs_extra(self, info):
        return {}

    def _rest_qpos(self) -> torch.Tensor:
        return torch.as_tensor(np.asarray(self.agent.keyframes["rest"].qpos, np.float32), device=self.device)


@register_env("FrankaMoveBenchmark-v1", max_episode_steps=200000)
class FrankaMoveBenchmarkEnv(_FrankaBenchmarkBase):
    def _load_agent(self, options):
        super()._load_agent(options, np.array([1.5, 0, 0, 0, 0, 0, 1.0]))  # yaw pi

    def _load_scene(self, options: dict):
        self.ground = build_ground(self.scene)

    def _initialize_episode(self, env_idx, options: dict):
        qpos = self._rest_qpos()
        qpos[0] = 0.5
        self.agent.reset(qpos)


@register_env("FrankaPickCubeBenchmark-v1", max_episode_steps=200000)
class FrankaPickCubeBenchmarkEnv(_FrankaBenchmarkBase):
    _solver_position_iterations = 10

    def _load_agent(self, options):
        super()._load_agent(options, np.array([0, 0, 0, 1.0, 0, 0, 0]))

    def _load_scene(self, options: dict):
        self.ground = build_ground(self.scene)
        self.cube = actors.build_cube(
            self.scene, half_size=0.02, color=[1, 0, 0, 1], name="cube",
            initial_pose=np.array([0.5, 0, 0.02, 1, 0, 0, 0]),
        )

    def _initialize_episode(self, env_idx, options: dict):
        self.agent.reset(self._rest_qpos())
        self.cube.set_pose(np.array([0.5, 0, 0.02, 1, 0, 0, 0], np.float32))
