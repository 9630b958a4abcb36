"""UnitreeG1PlaceAppleInBowl-v1 (counterpart of
maniskill_tpu/envs/tasks/humanoid/humanoid_pick_place.py).

The G1 upper body stands at a kitchen counter, grabs the apple with its
right hand and places it in the bowl to its side. The apple's xy is drawn
within +/-0.025 with a random z-rotation, the bowl's within +/-0.025 of
(0, -0.4). Success: the apple within 0.05 m of the bowl and the right hand
back above the bowl by at least 0.125 m. Staged dense reward reach -> grasp
-> lift over the bowl -> release. The apple is a sphere and the bowl a
walled dish on the procedural kitchen counter.
"""
from __future__ import annotations

import numpy as np
import torch

from ....scene_builder.kitchen_counter import KitchenCounterSceneBuilder
from ....sensors.camera import CameraConfig
from ....structs.pose import Pose
from ....utils.registration import register_env
from ....utils.scene_utils import look_at
from ...base_env import BaseEnv


class HumanoidPickPlaceEnv(BaseEnv):
    """The kitchen-counter scene of the humanoid pick-and-place tasks."""

    SUPPORTED_REWARD_MODES = ("sparse", "none")
    kitchen_scene_scale = 1.0

    def __init__(self, *args, robot_init_qpos_noise=0.02, **kwargs):
        self.robot_init_qpos_noise = robot_init_qpos_noise
        super().__init__(*args, **kwargs)

    @property
    def _default_sensor_configs(self):
        pose = look_at(eye=[0.3, 0, 0.6], target=[-0.1, 0, 0.1])
        return [CameraConfig("base_camera", pose, 128, 128, np.pi / 2, 0.01, 100)]

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at([0.6, 0.7, 0.6], [0.0, 0.0, 0.35])
        return CameraConfig("render_camera", pose, 512, 512, 1, 0.01, 100)

    def _load_scene(self, options: dict):
        self.scene_builder = KitchenCounterSceneBuilder(self)
        self.kitchen_scene = self.scene_builder.build(scale=self.kitchen_scene_scale)

    def _initialize_episode(self, env_idx: torch.Tensor, options: dict):
        self.scene_builder.initialize(env_idx)

    def evaluate(self):
        false = torch.zeros(self.num_envs, dtype=torch.bool, device=self.device)
        return {"success": false, "fail": false}

    def _get_obs_extra(self, info: dict):
        return dict()


@register_env("UnitreeG1PlaceAppleInBowl-v1", max_episode_steps=100)
class UnitreeG1PlaceAppleInBowlEnv(HumanoidPickPlaceEnv):
    """The G1 places the apple in the bowl with its right hand."""

    SUPPORTED_REWARD_MODES = ("normalized_dense", "dense", "sparse", "none")
    SUPPORTED_ROBOTS = ["unitree_g1_simplified_upper_body_with_head_camera"]
    kitchen_scene_scale = 0.82
    apple_radius = 0.03

    def __init__(self, *args, **kwargs):
        kwargs.pop("robot_uids", None)
        super().__init__(*args, robot_uids="unitree_g1_simplified_upper_body_with_head_camera", **kwargs)

    @property
    def _default_sensor_configs(self):
        pose = look_at(eye=[0.28, 0.3, 1.35], target=[0.0, -0.2, 0.75])
        return [CameraConfig("base_camera", pose, 128, 128, np.pi / 2, 0.01, 100)]

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at([0.28, 0.3, 1.35], [0.0, -0.2, 0.75])
        return CameraConfig("render_camera", pose, 512, 512, np.pi / 2, 0.01, 100)

    def _load_agent(self, options: dict):
        super()._load_agent(options, np.array([-0.3, 0, 0.755, 1, 0, 0, 0]))

    def _load_scene(self, options: dict):
        super()._load_scene(options)
        top = self.scene_builder.counter_top

        # the bowl: a kinematic walled dish, its origin at the base's centre
        b = self.scene.create_actor_builder()
        base = np.array([0.06, 0.06, 0.006])
        b.add_box_collision(pose=np.array([0, 0, base[2], 1, 0, 0, 0]), half_size=base)
        b.add_cylinder_visual(
            pose=np.array([0, 0, base[2], 0.7071068, 0, 0.7071068, 0]),
            radius=0.075, half_length=base[2], color=(0.9, 0.9, 0.95, 1),
        )
        for sx, sy, hx, hy in ((1, 0, 0.01, 0.06), (-1, 0, 0.01, 0.06), (0, 1, 0.06, 0.01), (0, -1, 0.06, 0.01)):
            wall = np.array([0.05 * sx, 0.05 * sy, 0.03, 1, 0, 0, 0])
            b.add_box_collision(pose=wall, half_size=np.array([hx, hy, 0.022]))
            b.add_box_visual(pose=wall, half_size=np.array([hx, hy, 0.022]), color=(0.9, 0.9, 0.95, 1))
        b.set_initial_pose(np.array([0, -0.4, top, 1, 0, 0, 0]))
        self.bowl = b.build_kinematic("bowl")

        # the apple: a dynamic sphere
        b = self.scene.create_actor_builder()
        b.add_sphere_collision(radius=self.apple_radius, density=800, friction=1.0)
        b.add_sphere_visual(radius=self.apple_radius, color=(0.75, 0.1, 0.05, 1))
        b.set_initial_pose(np.array([0, 0, top + self.apple_radius, 1, 0, 0, 0]))
        self.apple = b.build_dynamic("apple")

        dev = self.device
        self._standing_qpos = torch.as_tensor(
            np.asarray(self.agent.keyframes["standing"].qpos, np.float32), device=dev
        )[None]
        self._bowl_center = torch.as_tensor(np.array([0.0, -0.4], np.float32), device=dev)
        self._identity_q = torch.as_tensor(np.array([1, 0, 0, 0], np.float32), device=dev)
        self._hover = torch.as_tensor(np.array([0, 0, 0.15], np.float32), device=dev)

    def _initialize_episode(self, env_idx: torch.Tensor, options: dict):
        super()._initialize_episode(env_idx, options)
        top = self.scene_builder.counter_top
        rng = self._batched_episode_rng
        self.agent.reset(self._standing_qpos)

        xy = rng.uniform(-0.025, 0.025, (2,))
        xyz = torch.cat([xy, torch.full_like(xy[:, :1], top + self.apple_radius + 0.002)], -1)
        qs = rng.quaternions(lock_x=True, lock_y=True)
        self.apple.set_pose(Pose.create_from_pq(xyz, qs))

        bxy = rng.uniform(-0.025, 0.025, (2,)) + self._bowl_center
        bxyz = torch.cat([bxy, torch.full_like(bxy[:, :1], top)], -1)
        self.bowl.set_pose(Pose.create_from_pq(bxyz, self._identity_q))

    def evaluate(self):
        is_obj_placed = torch.linalg.vector_norm(self.bowl.pose.p - self.apple.pose.p, dim=1) <= 0.05
        hand_outside_bowl = self.agent.right_tcp.pose.p[:, 2] > self.bowl.pose.p[:, 2] + 0.125
        is_grasped = self.agent.right_hand_is_grasping(self.apple, max_angle=110)
        return {
            "success": is_obj_placed & hand_outside_bowl,
            "hand_outside_bowl": hand_outside_bowl,
            "is_grasped": is_grasped,
        }

    def _get_obs_extra(self, info: dict):
        obs = dict(is_grasped=info["is_grasped"], tcp_pose=self.agent.right_tcp.pose.raw_pose)
        if "state" in self.obs_mode:
            obs.update(
                bowl_pos=self.bowl.pose.p,
                obj_pose=self.apple.pose.raw_pose,
                tcp_to_obj_pos=self.apple.pose.p - self.agent.right_tcp.pose.p,
                obj_to_goal_pos=self.bowl.pose.p - self.apple.pose.p,
            )
        return obs

    def _grasp_release_reward(self):
        """Rewards opening the hand."""
        return 1 - torch.tanh(self.agent.right_hand_dist_to_open_grasp())

    def compute_dense_reward(self, obs, action, info):
        tcp_to_obj_dist = torch.linalg.vector_norm(self.apple.pose.p - self.agent.right_tcp.pose.p, dim=1)
        reward = 1 - torch.tanh(5 * tcp_to_obj_dist)

        is_grasped = info["is_grasped"].to(torch.float32)
        reward = reward + is_grasped

        # bring the apple to a hover point above the bowl, then release
        obj_to_goal_dist = torch.linalg.vector_norm((self.bowl.pose.p + self._hover) - self.apple.pose.p, dim=1)
        place_reward = 1 - torch.tanh(5 * obj_to_goal_dist)
        reward = reward + place_reward * is_grasped

        obj_high_above_bowl = obj_to_goal_dist < 0.025
        grasp_release_reward = self._grasp_release_reward()
        reward = torch.where(obj_high_above_bowl, 4 + place_reward + grasp_release_reward, reward)
        return torch.where(info["success"], 8 + place_reward + grasp_release_reward, reward)

    def compute_normalized_dense_reward(self, obs, action, info):
        return self.compute_dense_reward(obs, action, info) / 10
