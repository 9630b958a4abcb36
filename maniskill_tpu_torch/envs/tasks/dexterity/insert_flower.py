"""InsertFlower-v1 (counterpart of
maniskill_tpu/envs/tasks/dexterity/insert_flower.py).

A flower (a capsule stem and a sphere head) lies on the table; the floating
Panda gripper must pick it up and put it into the vase (a static ring of
box staves on a cylinder floor) so that its origin lands inside the target
box above the opening. The dense reward shapes the distance to that box.
"""
from __future__ import annotations

import numpy as np
import torch

from ....scene_builder.table import TableSceneBuilder
from ....sensors.camera import CameraConfig
from ....structs.pose import Pose
from ....utils.registration import register_env
from ....utils.scene_utils import look_at
from ...base_env import BaseEnv

VASE_R = 0.035
VASE_H = 0.12
STEM_R = 0.004
STEM_HL = 0.07


@register_env("InsertFlower-v1", max_episode_steps=300)
class InsertFlowerEnv(BaseEnv):
    SUPPORTED_ROBOTS = ["floating_panda_gripper"]

    def __init__(self, *args, robot_uids="floating_panda_gripper", **kwargs):
        super().__init__(*args, robot_uids=robot_uids, **kwargs)

    @property
    def _default_sensor_configs(self):
        pose = look_at(eye=[0.4, 0, 0.5], target=[0, 0, 0.1])
        return [CameraConfig("base_camera", pose, 128, 128, np.pi / 2, 0.01, 100)]

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at([0.5, 0.5, 0.5], [0.0, 0.0, 0.15])
        return CameraConfig("render_camera", pose, 512, 512, 1, 0.01, 100)

    def _load_agent(self, options: dict):
        super()._load_agent(options, np.array([0, -0.2, 0.25, 1, 0, 0, 0]))

    def _load_scene(self, options: dict):
        self.table_scene = TableSceneBuilder(self, robot_init_qpos_noise=0)
        self.table_scene.build()

        # the vase: a hollow cylinder made of a ring of box staves
        b = self.scene.create_actor_builder()
        n = 8
        for i in range(n):
            a = 2 * np.pi * i / n
            cx, cy = (VASE_R + 0.006) * np.cos(a), (VASE_R + 0.006) * np.sin(a)
            quat = np.array([np.cos(a / 2), 0, 0, np.sin(a / 2)])
            b.add_box_collision(pose=[cx, cy, 0, *quat], half_size=[0.006, 0.016, VASE_H / 2])
            b.add_box_visual(pose=[cx, cy, 0, *quat], half_size=[0.006, 0.016, VASE_H / 2],
                             color=[0.4, 0.5, 0.8, 1])
        b.add_cylinder_collision(pose=[0, 0, -VASE_H / 2 + 0.005, 0.7071068, 0, 0.7071068, 0], radius=VASE_R,
                                 half_length=0.005)
        b.set_initial_pose([0.12, 0.0, VASE_H / 2, 1, 0, 0, 0])
        self.vase = b.build_static(name="vase")

        # the flower: a stem capsule and a head sphere
        fb = self.scene.create_actor_builder()
        fb.add_capsule_collision(pose=[0, 0, 0, 0.7071068, 0, 0.7071068, 0], radius=STEM_R, half_length=STEM_HL,
                                 density=300)
        fb.add_capsule_visual(pose=[0, 0, 0, 0.7071068, 0, 0.7071068, 0], radius=STEM_R, half_length=STEM_HL,
                              color=[0.2, 0.6, 0.2, 1])
        fb.add_sphere_collision(pose=[STEM_HL + 0.012, 0, 0, 1, 0, 0, 0], radius=0.015, density=200)
        fb.add_sphere_visual(pose=[STEM_HL + 0.012, 0, 0, 1, 0, 0, 0], radius=0.015, color=[0.9, 0.4, 0.7, 1])
        fb.set_initial_pose([-0.1, 0.0, STEM_R + 0.001, 1, 0, 0, 0])
        self.flower = fb.build(name="flower")

    def _after_reconfigure(self, options: dict):
        dev = self.device
        # the flower origin's target: a box over the vase's mouth
        cx, cy = 0.12, 0.0
        self.target_area_box = torch.tensor([[cx - 0.03, cy - 0.03, VASE_H * 0.45],
                                             [cx + 0.03, cy + 0.03, VASE_H + 0.1]], device=dev)
        self._flower_xy0 = torch.tensor([-0.1, 0.0], device=dev)
        self._identity_q = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
        self._vase_top = torch.tensor([0.12, 0.0, VASE_H], device=dev)

    def _initialize_episode(self, env_idx, options: dict):
        b = self.num_envs
        self.table_scene.initialize(env_idx)
        xy = self._batched_episode_rng.uniform(-0.04, 0.04, (2,)) + self._flower_xy0
        xyz = torch.cat([xy, torch.full((b, 1), STEM_R + 0.001, device=self.device)], -1)
        self.flower.set_pose(Pose.create_from_pq(xyz, self._identity_q))
        self.agent.reset()

    def evaluate(self):
        p = self.flower.pose.p
        lo, hi = self.target_area_box[0], self.target_area_box[1]
        return {"success": torch.all(p >= lo, -1) & torch.all(p <= hi, -1)}

    def _get_obs_extra(self, info: dict):
        obs = dict(tcp_pose=self.agent.tcp_pose.raw_pose)
        if "state" in self.obs_mode:
            obs.update(flower_pose=self.flower.pose.raw_pose, vase_top=self._vase_top.expand(self.num_envs, 3))
        return obs

    def compute_dense_reward(self, obs, action, info):
        p = self.flower.pose.p
        lo, hi = self.target_area_box[0], self.target_area_box[1]
        dist_outside = torch.clamp(lo - p, min=0.0) + torch.clamp(p - hi, min=0.0)
        d = torch.linalg.vector_norm(dist_outside, dim=-1)
        reach = torch.linalg.vector_norm(p - self.agent.tcp_pose.p, dim=-1)
        reward = (1 - torch.tanh(5 * reach)) + 2 * (1 - torch.tanh(5 * d))
        return torch.where(info["success"], 5.0, reward)

    def compute_normalized_dense_reward(self, obs, action, info):
        return self.compute_dense_reward(obs, action, info) / 5.0
