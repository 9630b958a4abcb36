"""TriFingerRotateCubeLevel{0-4}-v1 (counterpart of
maniskill_tpu/envs/tasks/dexterity/rotate_cube.py).

A 6.5 cm cube in the TriFinger arena must be moved, and at the higher
levels reoriented, to a sampled goal pose; success is the position within
2 cm and the orientation within 0.1 rad. Goals by level: 0 a random table
position, 1 the same with a random yaw, 2 a fixed lifted position, 3 a
random position in the air, 4 a random pose in the air.
"""
from __future__ import annotations

import numpy as np
import torch

from ....building import actors
from ....building.ground import build_ground
from ....sensors.camera import CameraConfig
from ....structs.pose import Pose
from ....utils.geometry.rotation_conversions import quat_diff_rad
from ....utils.registration import register_env
from ....utils.scene_utils import look_at
from ...base_env import BaseEnv


class RotateCubeEnv(BaseEnv):
    SUPPORTED_ROBOTS = ["trifingerpro"]

    goal_radius = 0.02
    cube_half_size = 0.02
    ARENA_RADIUS = 0.195
    size = 0.065
    max_len = 0.065
    radius_3d = max_len * np.sqrt(3) / 2
    max_com_distance_to_center = ARENA_RADIUS - radius_3d
    min_height = 0.065 / 2
    max_height = 0.1

    def __init__(self, *args, robot_uids="trifingerpro", robot_init_qpos_noise=0.02, difficulty_level: int = 4,
                 **kwargs):
        self.robot_init_qpos_noise = robot_init_qpos_noise
        if not isinstance(difficulty_level, int) or difficulty_level >= 5 or difficulty_level < 0:
            raise ValueError(f"Difficulty level must be a int within 0-4, but get {difficulty_level}")
        self.difficulty_level = difficulty_level
        super().__init__(*args, robot_uids=robot_uids, **kwargs)

    @property
    def _default_sensor_configs(self):
        pose = look_at(eye=(0.7, 0.0, 0.7), target=(0.0, 0.0, 0.0))
        return [CameraConfig("base_camera", pose, 128, 128, np.pi / 2, 0.01, 100)]

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at(eye=(0.7, 0.0, 0.7), target=(0.0, 0.0, 0.0))
        return CameraConfig("render_camera", pose, 512, 512, 1, 0.01, 100)

    def _load_agent(self, options: dict):
        # the base stands so that the finger tips reach the arena floor
        super()._load_agent(options, np.array([0, 0, self.size / 2 + 0.022, 1, 0, 0, 0]))

    def _load_scene(self, options: dict):
        self.ground = build_ground(self.scene, altitude=0)
        # the arena's boundary: a ring of 8 static boxes
        n_wall = 8
        for i in range(n_wall):
            a = 2 * np.pi * i / n_wall
            r = self.ARENA_RADIUS + 0.02
            b = self.scene.create_actor_builder()
            b.add_box_collision(half_size=[0.02, 0.09, 0.05])
            b.add_box_visual(half_size=[0.02, 0.09, 0.05], color=[0.7, 0.7, 0.7, 1])
            quat = np.array([np.cos(a / 2), 0, 0, np.sin(a / 2)])
            b.set_initial_pose(np.concatenate([[r * np.cos(a), r * np.sin(a), 0.05], quat]))
            b.build_static(name=f"arena_wall_{i}")

        self.obj = actors.build_colorful_cube(
            self.scene, half_size=self.size / 2, color=np.array([169, 42, 12, 255]) / 255, name="cube",
            initial_pose=np.array([0, 0, self.size / 2 + 0.005, 1, 0, 0, 0]),
        )
        self.obj_goal = actors.build_colorful_cube(
            self.scene, half_size=self.size / 2, color=np.array([12, 160, 42, 255]) / 255, name="cube_goal",
            body_type="kinematic", add_collision=False, initial_pose=np.array([0, 0, 0.1, 1, 0, 0, 0]),
        )
        self._hidden_objects.append(self.obj_goal)

    def _after_reconfigure(self, options: dict):
        dev = self.device
        self._identity_q = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
        self._obj_start = torch.tensor([0.0, 0.0, self.size / 2 + 0.005], device=dev)
        self._init_xyz = torch.tensor([0.0, 0.0, 0.032], device=dev)

    def _sample_object_goal_poses(self, rng, difficulty: int):
        """(B, 3) goal positions and (B, 4) orientations of one level."""
        b = self.num_envs
        default_orn = self._identity_q.expand(b, 4)

        def random_xy():
            radius = torch.sqrt(rng.uniform(0.0, 1.0)) * self.max_com_distance_to_center
            theta = 2 * np.pi * rng.uniform(0.0, 1.0)
            return radius * torch.cos(theta), radius * torch.sin(theta)

        def full(v):
            return torch.full((b,), v, dtype=torch.float32, device=self.device)

        if difficulty == 0:
            x, y = random_xy()
            z, orn = full(self.size / 2), default_orn
        elif difficulty == 1:
            x, y = random_xy()
            z, orn = full(self.size / 2), rng.quaternions(lock_x=True, lock_y=True)
        elif difficulty == 2:
            x, y, z, orn = full(0.0), full(0.0), full(self.min_height + 0.05), default_orn
        elif difficulty == 3:
            x, y = random_xy()
            z, orn = rng.uniform(self.min_height, self.max_height), default_orn
        else:
            x, y = random_xy()
            z, orn = rng.uniform(self.radius_3d, self.max_height), rng.quaternions()
        return torch.stack([x, y, z], -1), orn

    def _initialize_episode(self, env_idx, options: dict):
        rng = self._batched_episode_rng
        self.obj.set_pose(Pose.create_from_pq(self._obj_start.expand(self.num_envs, 3), self._identity_q))
        pos, orn = self._sample_object_goal_poses(rng, self.difficulty_level)
        self.obj_goal.set_pose(Pose.create_from_pq(pos, orn))
        # the joints start at the noise alone, as in the JAX package
        self.agent.reset(rng.normal(0.0, self.robot_init_qpos_noise, (self.agent.robot.dof,)))

    def evaluate(self):
        pos_close = torch.linalg.vector_norm(self.obj.pose.p - self.obj_goal.pose.p, dim=1) < self.goal_radius
        q_close = quat_diff_rad(self.obj.pose.q, self.obj_goal.pose.q) < 0.1
        return {"success": pos_close & q_close}

    def _get_obs_extra(self, info: dict):
        obs = dict(goal_pos=self.obj_goal.pose.p, goal_q=self.obj_goal.pose.q)
        if "state" in self.obs_mode:
            obs.update(obj_p=self.obj.pose.p, obj_q=self.obj.pose.q)
        return obs

    def compute_dense_reward(self, obs, action, info):
        obj_pos = self.obj.pose.p
        goal_pos = self.obj_goal.pose.p
        object_dist_weight = 5.0
        object_rot_weight = 5.0

        tip_poses = self.agent.tip_poses  # (B, 7, 3)
        reach = 0.0
        for i in range(3):
            d = torch.linalg.vector_norm(tip_poses[:, :3, i] - obj_pos, dim=-1)
            reach = reach + (1 - torch.tanh(5 * d))
        finger_reach_object_reward = object_dist_weight * reach / 3

        object_dist = torch.linalg.vector_norm(obj_pos - goal_pos, dim=-1)
        init_dist = torch.linalg.vector_norm(self._init_xyz[None] - goal_pos, dim=-1)
        object_dist_reward = (1 - torch.tanh(5 * object_dist)) - (1 - torch.tanh(5 * init_dist))

        object_z_dist = torch.abs(obj_pos[..., 2] - goal_pos[..., 2])
        init_z_dist = torch.abs(0.032 - goal_pos[..., 2])
        object_lift_reward = 5 * (1 - torch.tanh(5 * object_z_dist)) - 5 * (1 - torch.tanh(5 * init_z_dist))

        object_rot_reward = -torch.abs(quat_diff_rad(self.obj.pose.q, self.obj_goal.pose.q))

        pose_reward = (object_dist_weight * (object_dist_reward + object_lift_reward)
                       + object_rot_weight * object_rot_reward)
        total = torch.clamp(finger_reach_object_reward + pose_reward, -15, 15)
        return torch.where(info["success"], 15.0, total)

    def compute_normalized_dense_reward(self, obs, action, info):
        return self.compute_dense_reward(obs=obs, action=action, info=info) / 30 + 0.5


def _make_level(level):
    @register_env(f"TriFingerRotateCubeLevel{level}-v1", max_episode_steps=250)
    class RotateCubeEnvLevel(RotateCubeEnv):
        def __init__(self, *args, **kwargs):
            kwargs.setdefault("robot_init_qpos_noise", 0.02)
            kwargs["difficulty_level"] = level
            super().__init__(*args, **kwargs)

    RotateCubeEnvLevel.__name__ = f"RotateCubeEnvLevel{level}"
    return RotateCubeEnvLevel


RotateCubeEnvLevel0 = _make_level(0)
RotateCubeEnvLevel1 = _make_level(1)
RotateCubeEnvLevel2 = _make_level(2)
RotateCubeEnvLevel3 = _make_level(3)
RotateCubeEnvLevel4 = _make_level(4)
