"""Empty-v1 (counterpart of maniskill_tpu/envs/tasks/empty_env.py): a
ground plane and a robot, for building and stepping any robot."""
from __future__ import annotations

import numpy as np

from ...building.ground import build_ground
from ...sensors.camera import CameraConfig
from ...utils.registration import register_env
from ...utils.scene_utils import look_at
from ..base_env import BaseEnv


@register_env("Empty-v1", max_episode_steps=200000)
class EmptyEnv(BaseEnv):
    SUPPORTED_REWARD_MODES = ("none",)

    def __init__(self, *args, robot_uids="panda", **kwargs):
        super().__init__(*args, robot_uids=robot_uids, **kwargs)

    @property
    def _default_sensor_configs(self):
        pose = look_at([1.25, -1.25, 1.5], [0.0, 0.0, 0.2])
        return [CameraConfig("base_camera", pose, 128, 128, np.pi / 2, 0.01, 100)]

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at([1.25, -1.25, 1.5], [0.0, 0.0, 0.2])
        return CameraConfig("render_camera", pose, 512, 512, 1, 0.01, 100)

    def _load_agent(self, options: dict):
        super()._load_agent(options, np.array([0, 0, 0, 1, 0, 0, 0]))

    def _load_scene(self, options: dict):
        self.ground = build_ground(self.scene)

    def evaluate(self):
        return {}

    def _get_obs_extra(self, info: dict):
        return dict()
