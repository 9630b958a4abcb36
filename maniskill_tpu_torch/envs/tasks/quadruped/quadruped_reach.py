"""AnymalC-Reach-v1 / UnitreeGo2-Reach-v1 (counterpart of
maniskill_tpu/envs/tasks/quadruped/quadruped_reach.py).

The quadruped starts standing and must walk to a goal 2.5 +/- 0.5 m ahead
(+/- 1 m sideways); success is being within 0.35 m of it and not fallen;
it fails when the body touches the ground. The dense reward is progress to
the goal with velocity, contact and posture penalties. The base camera is
mounted on the floating base.
"""
from __future__ import annotations

import numpy as np
import torch

from ....building import actors
from ....building.ground import build_ground
from ....sensors.camera import CameraConfig
from ....structs.pose import Pose
from ....structs.types import SceneConfig, SimConfig
from ....utils.registration import register_env
from ....utils.scene_utils import look_at
from ...base_env import BaseEnv


class QuadrupedEnv(BaseEnv):
    """The quadruped tasks' shared scene: a standing start from the robot's
    keyframe, a base camera on the floating base, and the penalty terms."""

    _UNDESIRED_CONTACT_LINK_NAMES = None
    default_qpos: np.ndarray

    @property
    def _default_sim_config(self):
        return SimConfig(scene_config=SceneConfig(solver_position_iterations=4, solver_velocity_iterations=0))

    @property
    def _default_sensor_configs(self):
        pose = look_at(eye=[0.5, 0, 0.1], target=[1.0, 0, 0.0])
        return [CameraConfig("base_camera", pose, 128, 128, np.pi / 2, 0.01, 100,
                             mount=self.agent.robot.links[0])]

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at([-2.0, 1.5, 3], [1.5, 0.0, 0.5])
        return CameraConfig("render_camera", pose, 512, 512, 1, 0.01, 100)

    def _load_agent(self, options: dict):
        super()._load_agent(options, np.array([0, 0, 1, 1, 0, 0, 0]))

    def _after_reconfigure(self, options: dict):
        kf = self.agent.keyframes["standing"]
        self._kf_pose = torch.as_tensor(kf.pose, dtype=torch.float32, device=self.device)
        self._kf_qpos = torch.as_tensor(kf.qpos, dtype=torch.float32, device=self.device)
        self._default_qpos = torch.as_tensor(self.default_qpos, dtype=torch.float32, device=self.device)

    def _initialize_episode(self, env_idx, options: dict):
        self.agent.robot.set_root_pose(self._kf_pose)
        self.agent.reset(self._kf_qpos)

    def _compute_undesired_contacts(self, threshold=1.0):
        forces = self.agent.robot.get_net_contact_forces(self._UNDESIRED_CONTACT_LINK_NAMES)
        return torch.linalg.vector_norm(forces, dim=-1).amax(-1) > threshold

    def _penalties(self):
        robot = self.agent.robot
        lin_vel_z_l2 = torch.square(robot.root_linear_velocity[:, 2])
        ang_vel_xy_l2 = torch.square(robot.root_angular_velocity[:, :2]).sum(1)
        return (
            lin_vel_z_l2 * -2
            + ang_vel_xy_l2 * -0.05
            + self._compute_undesired_contacts().to(torch.float32) * -1
            + torch.linalg.vector_norm(robot.qpos - self._default_qpos, dim=1) * -0.05
        )


class QuadrupedReachEnv(QuadrupedEnv):
    SUPPORTED_ROBOTS = ["anymal_c", "unitree_go2_simplified_locomotion"]

    def __init__(self, *args, robot_uids="anymal_c", **kwargs):
        super().__init__(*args, robot_uids=robot_uids, **kwargs)

    def _load_scene(self, options: dict):
        self.ground = build_ground(self.scene)
        self.goal = actors.build_sphere(
            self.scene, radius=0.2, color=[0, 1, 0, 1], name="goal", add_collision=False,
            body_type="kinematic", initial_pose=np.array([2.5, 0, 0.2, 1, 0, 0, 0]),
        )

    def _after_reconfigure(self, options: dict):
        super()._after_reconfigure(options)
        self._goal_z_quat = torch.tensor([0.2, 1.0, 0.0, 0.0, 0.0], device=self.device)

    def _initialize_episode(self, env_idx, options: dict):
        super()._initialize_episode(env_idx, options)
        rng = self._batched_episode_rng
        x = rng.uniform(0.0, 1.0) - 0.5 + 2.5
        y = rng.uniform(0.0, 2.0) - 1.0
        z_quat = self._goal_z_quat.expand(self.num_envs, 5)
        self.goal.set_pose(Pose(torch.cat([x[:, None], y[:, None], z_quat], -1)))

    def evaluate(self):
        is_fallen = self.agent.is_fallen()
        robot_to_goal_dist = torch.linalg.vector_norm(
            self.goal.pose.p[:, :2] - self.agent.robot.pose.p[:, :2], dim=1)
        reached_goal = robot_to_goal_dist < 0.35
        return {
            "success": reached_goal & ~is_fallen,
            "fail": is_fallen,
            "robot_to_goal_dist": robot_to_goal_dist,
            "reached_goal": reached_goal,
            "is_fallen": is_fallen,
        }

    def _get_obs_extra(self, info: dict):
        robot = self.agent.robot
        obs = dict(
            root_linear_velocity=robot.root_linear_velocity,
            root_angular_velocity=robot.root_angular_velocity,
            reached_goal=info["success"],
        )
        if "state" in self.obs_mode:
            obs.update(
                goal_pos=self.goal.pose.p[:, :2],
                robot_to_goal=self.goal.pose.p[:, :2] - robot.pose.p[:, :2],
            )
        return obs

    def compute_dense_reward(self, obs, action, info):
        reaching_reward = 1 - torch.tanh(info["robot_to_goal_dist"])
        reward = 1 + 2 * reaching_reward + self._penalties()
        return torch.where(info["fail"], 0.0, reward)

    def compute_normalized_dense_reward(self, obs, action, info):
        return self.compute_dense_reward(obs=obs, action=action, info=info) / 3.0


@register_env("AnymalC-Reach-v1", max_episode_steps=200)
class AnymalCReachEnv(QuadrupedReachEnv):
    _UNDESIRED_CONTACT_LINK_NAMES = ["LF_SHANK", "LH_SHANK", "RF_SHANK", "RH_SHANK"]

    def __init__(self, *args, robot_uids="anymal_c", **kwargs):
        from ....agents.robots.anymal.anymal_c import ANYmalC

        self.default_qpos = ANYmalC.keyframes["standing"].qpos
        super().__init__(*args, robot_uids=robot_uids, **kwargs)


@register_env("UnitreeGo2-Reach-v1", max_episode_steps=200)
class UnitreeGo2ReachEnv(QuadrupedReachEnv):
    _UNDESIRED_CONTACT_LINK_NAMES = ["FL_thigh", "FR_thigh", "RL_thigh", "RR_thigh"]

    def __init__(self, *args, robot_uids="unitree_go2_simplified_locomotion", **kwargs):
        from ....agents.robots.unitree_go.unitree_go2 import UnitreeGo2Simplified

        self.default_qpos = UnitreeGo2Simplified.keyframes["standing"].qpos
        super().__init__(*args, robot_uids=robot_uids, **kwargs)
