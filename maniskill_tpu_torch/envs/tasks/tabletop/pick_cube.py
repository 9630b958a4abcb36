"""PickCube-v1 (counterpart of maniskill_tpu/envs/tasks/tabletop/pick_cube.py).

A cube spawns in a square around a center with a random yaw; a goal site
floats up to ``max_goal_height`` above; success = cube within
``goal_thresh`` of the goal AND the robot static; staged dense reward
reach -> grasp -> place -> still.
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


@register_env("PickCube-v1", max_episode_steps=50)
class PickCubeEnv(BaseEnv):
    SUPPORTED_ROBOTS = ["panda"]

    cube_half_size = 0.02
    goal_thresh = 0.025
    cube_spawn_half_size = 0.05
    cube_spawn_center = (0.0, 0.0)
    max_goal_height = 0.3

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
        self.cube = actors.build_cube(
            self.scene,
            half_size=self.cube_half_size,
            color=[1, 0, 0, 1],
            name="cube",
            initial_pose=np.array([0, 0, self.cube_half_size, 1, 0, 0, 0]),
        )
        self.goal_site = actors.build_sphere(
            self.scene,
            radius=self.goal_thresh,
            color=[0, 1, 0, 1],
            name="goal_site",
            body_type="kinematic",
            add_collision=False,
            initial_pose=np.array([0, 0, 0, 1, 0, 0, 0]),
        )
        self._hidden_objects.append(self.goal_site)
        self._spawn_center = torch.tensor(self.cube_spawn_center, device=self.device)

    def _initialize_episode(self, env_idx: torch.Tensor, options: dict):
        self.table_scene.initialize(env_idx)
        rng = self._batched_episode_rng
        center = self._spawn_center
        half = self.cube_spawn_half_size
        xy = rng.uniform(-half, half, (2,)) + center
        xyz = torch.cat([xy, torch.full_like(xy[:, :1], self.cube_half_size)], -1)
        self.cube.set_pose(Pose(torch.cat([xyz, rng.quaternions(lock_x=True, lock_y=True)], -1)))

        gxy = rng.uniform(-half, half, (2,)) + center
        gz = rng.uniform(0.0, self.max_goal_height) + xyz[:, 2]
        goal = torch.cat([gxy, gz[:, None]], -1)
        self.goal_site.set_pose(Pose(torch.cat([goal, self._identity_quat(goal)], -1)))

    @staticmethod
    def _identity_quat(p: torch.Tensor) -> torch.Tensor:
        q = torch.zeros(p.shape[:-1] + (4,), device=p.device)
        q[..., 0] = 1.0
        return q

    def _get_obs_extra(self, info: dict):
        obs = dict(
            is_grasped=info["is_grasped"],
            tcp_pose=self.agent.tcp_pose.raw_pose,
            goal_pos=self.goal_site.pose.p,
        )
        if "state" in self.obs_mode:
            obs.update(
                obj_pose=self.cube.pose.raw_pose,
                tcp_to_obj_pos=self.cube.pose.p - self.agent.tcp_pose.p,
                obj_to_goal_pos=self.goal_site.pose.p - self.cube.pose.p,
            )
        return obs

    def evaluate(self):
        is_obj_placed = (
            torch.linalg.vector_norm(self.goal_site.pose.p - self.cube.pose.p, dim=1)
            <= self.goal_thresh
        )
        is_grasped = self.agent.is_grasping(self.cube)
        is_robot_static = self.agent.is_static(0.2)
        return {
            "success": is_obj_placed & is_robot_static,
            "is_obj_placed": is_obj_placed,
            "is_robot_static": is_robot_static,
            "is_grasped": is_grasped,
        }

    def compute_dense_reward(self, obs, action, info):
        tcp_to_obj_dist = torch.linalg.vector_norm(self.cube.pose.p - self.agent.tcp_pose.p, dim=1)
        reward = 1 - torch.tanh(5 * tcp_to_obj_dist)

        is_grasped = info["is_grasped"].to(torch.float32)
        reward = reward + is_grasped

        obj_to_goal_dist = torch.linalg.vector_norm(self.goal_site.pose.p - self.cube.pose.p, dim=1)
        place_reward = 1 - torch.tanh(5 * obj_to_goal_dist)
        reward = reward + place_reward * is_grasped

        # the reference slices off the last two joints for every robot
        qvel = self.agent.robot.qvel[..., :-2]
        static_reward = 1 - torch.tanh(5 * torch.linalg.vector_norm(qvel, dim=1))
        reward = reward + static_reward * info["is_obj_placed"].to(torch.float32)

        return torch.where(info["success"], 5.0, reward)

    def compute_normalized_dense_reward(self, obs, action, info):
        return self.compute_dense_reward(obs=obs, action=action, info=info) / 5


@register_env("PickCubeSO100-v1", max_episode_steps=50)
class PickCubeSO100Env(PickCubeEnv):
    """PickCube with the SO100 arm, its base at x = -0.4. The static reward
    still slices off the last two joints (``compute_dense_reward``), as the
    reference does for every robot: for the SO100 that also drops its last
    arm joint."""

    SUPPORTED_ROBOTS = ["so100"]

    def __init__(self, *args, **kwargs):
        kwargs.pop("robot_uids", None)
        super().__init__(*args, robot_uids="so100", **kwargs)

    def _load_agent(self, options: dict):
        BaseEnv._load_agent(self, options, np.array([-0.4, 0, 0, 1, 0, 0, 0]))


@register_env("PickCubeWidowXAI-v1", max_episode_steps=50)
class PickCubeWidowXAIEnv(PickCubeEnv):
    """PickCube with the WidowX AI arm, its base at x = -0.45."""

    SUPPORTED_ROBOTS = ["widowxai"]

    def __init__(self, *args, **kwargs):
        kwargs.pop("robot_uids", None)
        super().__init__(*args, robot_uids="widowxai", **kwargs)

    def _load_agent(self, options: dict):
        BaseEnv._load_agent(self, options, np.array([-0.45, 0, 0, 1, 0, 0, 0]))
