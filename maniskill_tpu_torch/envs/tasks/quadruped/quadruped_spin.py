"""AnymalC-Spin-v1 (counterpart of
maniskill_tpu/envs/tasks/quadruped/quadruped_spin.py).

Spin in place as fast as possible: the reward is the root's yaw rate with
velocity, contact and posture penalties, and -100 once the body touches the
ground (a failure). There is no success condition.
"""
from __future__ import annotations

import torch

from ....building.ground import build_ground
from ....utils.registration import register_env
from .quadruped_reach import QuadrupedEnv


class QuadrupedSpinEnv(QuadrupedEnv):
    SUPPORTED_ROBOTS = ["anymal_c"]

    def __init__(self, *args, robot_uids="anymal_c", **kwargs):
        super().__init__(*args, robot_uids=robot_uids, **kwargs)

    def _load_scene(self, options: dict):
        self.ground = build_ground(self.scene)

    def evaluate(self):
        is_fallen = self.agent.is_fallen()
        return {"fail": is_fallen, "is_fallen": is_fallen}

    def _get_obs_extra(self, info: dict):
        return dict(
            root_linear_velocity=self.agent.robot.root_linear_velocity,
            root_angular_velocity=self.agent.robot.root_angular_velocity,
        )

    def compute_dense_reward(self, obs, action, info):
        reward = 2 * self.agent.robot.root_angular_velocity[:, 2] + self._penalties()
        return torch.where(info["fail"], -100.0, reward)

    def compute_normalized_dense_reward(self, obs, action, info):
        return self.compute_dense_reward(obs=obs, action=action, info=info) / 2.0


@register_env("AnymalC-Spin-v1", max_episode_steps=200)
class AnymalCSpinEnv(QuadrupedSpinEnv):
    _UNDESIRED_CONTACT_LINK_NAMES = ["LF_SHANK", "LH_SHANK", "RF_SHANK", "RH_SHANK"]

    def __init__(self, *args, robot_uids="anymal_c", **kwargs):
        from ....agents.robots.anymal.anymal_c import ANYmalC

        self.default_qpos = ANYmalC.keyframes["standing"].qpos
        super().__init__(*args, robot_uids=robot_uids, **kwargs)
