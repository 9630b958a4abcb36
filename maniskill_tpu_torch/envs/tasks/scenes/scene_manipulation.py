"""SceneManipulation-v1 (counterpart of
maniskill_tpu/envs/tasks/scenes/scene_manipulation.py).

A scene-level sandbox: a registered scene builder (ReplicaCAD by default)
populates the world and a mobile robot (the Fetch by default) explores and
manipulates it. No success metric and no reward: exploration,
visualisation and data collection in furnished rooms.
"""
from __future__ import annotations

import numpy as np
import torch

from ....scene_builder.ai2thor import variants as _thor  # noqa: F401 (registers the AI2THOR builders)
from ....scene_builder.registration import REGISTERED_SCENE_BUILDERS
from ....scene_builder.replicacad import ReplicaCADSceneBuilder  # noqa: F401 (registers)
from ....scene_builder.robocasa import RoboCasaSceneBuilder  # noqa: F401 (registers)
from ....sensors.camera import CameraConfig
from ....utils.registration import register_env
from ....utils.scene_utils import look_at
from ...base_env import BaseEnv


@register_env("SceneManipulation-v1", max_episode_steps=200)
class SceneManipulationEnv(BaseEnv):
    SUPPORTED_ROBOTS = ["panda", "fetch"]
    SUPPORTED_REWARD_MODES = ("none",)

    def __init__(self, *args, robot_uids="fetch", scene_builder_cls="ReplicaCAD", build_config_idxs=None,
                 init_config_idxs=None, num_envs=1, reconfiguration_freq=None, **kwargs):
        if isinstance(scene_builder_cls, str):
            scene_builder_cls = REGISTERED_SCENE_BUILDERS[scene_builder_cls].scene_builder_cls
        self.scene_builder = None
        self._scene_builder_cls = scene_builder_cls
        self.build_config_idxs = build_config_idxs
        self.init_config_idxs = init_config_idxs
        super().__init__(*args, robot_uids=robot_uids, reconfiguration_freq=reconfiguration_freq or 0,
                         num_envs=num_envs, **kwargs)

    @property
    def _default_sensor_configs(self):
        pose = look_at([0.3, 0, 0.6], [-0.1, 0, 0.1])
        return [CameraConfig("base_camera", pose, 128, 128, np.pi / 2, 0.01, 100)]

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at([3.5, 3.5, 3.0], [0.0, 0.0, 0.5])
        return CameraConfig("render_camera", pose, 512, 512, 1, 0.01, 100)

    def _load_agent(self, options: dict):
        # the builder first: it says where the robot stands
        self.scene_builder = self._scene_builder_cls(
            self, robot_init_qpos_noise=getattr(self, "robot_init_qpos_noise", 0.02))
        super()._load_agent(options, self.scene_builder.robot_initial_pose)

    def _load_scene(self, options: dict):
        self.scene_builder.build(self.build_config_idxs)

    def _initialize_episode(self, env_idx: torch.Tensor, options: dict):
        self.scene_builder.initialize(env_idx, self.init_config_idxs)

    def evaluate(self):
        return {}

    def _get_obs_extra(self, info: dict):
        return dict()


# one id per registered scene builder, creatable by id alone (the
# reference's registration loop): ReplicaCAD, the four AI2THOR builders and
# RoboCasa
for _k in list(REGISTERED_SCENE_BUILDERS):
    register_env(f"{_k}_SceneManipulation-v1", max_episode_steps=200, scene_builder_cls=_k)(SceneManipulationEnv)
