"""UnitreeH1Stand-v1 / UnitreeG1Stand-v1 (counterpart of
maniskill_tpu/envs/tasks/humanoid/humanoid_stand.py).

The humanoid starts in a noisy standing keyframe and must stay standing
(its root height inside the robot's band); the reward is sparse
(is_standing), and it fails when not standing.
"""
from __future__ import annotations

import numpy as np
import torch

from ....building.ground import build_ground
from ....sensors.camera import CameraConfig
from ....utils.registration import register_env
from ....utils.scene_utils import look_at
from ...base_env import BaseEnv


class HumanoidStandEnv(BaseEnv):
    SUPPORTED_REWARD_MODES = ("sparse", "none")

    def __init__(self, *args, robot_uids="unitree_h1_simplified", robot_init_qpos_noise=0.02, **kwargs):
        self.robot_init_qpos_noise = robot_init_qpos_noise
        super().__init__(*args, robot_uids=robot_uids, **kwargs)

    @property
    def _default_sensor_configs(self):
        return []

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at([1.0, 1.0, 2.5], [0.0, 0.0, 0.75])
        return CameraConfig("render_camera", pose, 512, 512, 1, 0.01, 100)

    def _load_agent(self, options: dict):
        super()._load_agent(options, np.array([0, 0, 1.05, 1, 0, 0, 0]))

    def _load_scene(self, options: dict):
        build_ground(self.scene)

    def _after_reconfigure(self, options: dict):
        kf = self.agent.keyframes["standing"]
        self._kf_pose = torch.as_tensor(kf.pose, dtype=torch.float32, device=self.device)
        self._kf_qpos = torch.as_tensor(kf.qpos, dtype=torch.float32, device=self.device)

    def _initialize_episode(self, env_idx, options: dict):
        # the noise is 0.05 whatever robot_init_qpos_noise says, as in the
        # JAX package
        noise = self._batched_episode_rng.normal(0.0, 0.05, (self.agent.robot.dof,))
        self.agent.robot.set_root_pose(self._kf_pose)
        self.agent.reset(self._kf_qpos + noise)

    def evaluate(self):
        is_standing = self.agent.is_standing()
        return {"is_standing": is_standing, "fail": ~is_standing}

    def _get_obs_extra(self, info: dict):
        return dict()

    def compute_sparse_reward(self, obs, action, info):
        return info["is_standing"].to(torch.float32)


@register_env("UnitreeH1Stand-v1", max_episode_steps=1000)
class UnitreeH1StandEnv(HumanoidStandEnv):
    SUPPORTED_ROBOTS = ["unitree_h1_simplified"]

    def __init__(self, *args, robot_uids="unitree_h1_simplified", **kwargs):
        super().__init__(*args, robot_uids=robot_uids, **kwargs)


@register_env("UnitreeG1Stand-v1", max_episode_steps=1000)
class UnitreeG1StandEnv(HumanoidStandEnv):
    SUPPORTED_ROBOTS = ["unitree_g1_simplified_legs"]

    def __init__(self, *args, robot_uids="unitree_g1_simplified_legs", **kwargs):
        super().__init__(*args, robot_uids=robot_uids, **kwargs)

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at([1.0, 1.0, 2.0], [0.0, 0.0, 0.75])
        return CameraConfig("render_camera", pose, 512, 512, 1, 0.01, 100)
