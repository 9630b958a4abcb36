"""FMBAssembly1Easy-v1 (counterpart of maniskill_tpu/envs/tasks/fmb/fmb.py).

A bridge part must be placed onto its target pose on the assembly board;
success: the bridge within 5 mm of its goal. The board and its two mounting
studs are procedural boxes; the bridge is a nonconvex arch cooked into one
hull proxy per block.
"""
from __future__ import annotations

import numpy as np
import torch

from ....building.cooking import hull_proxy
from ....scene_builder.table import TableSceneBuilder
from ....sensors.camera import CameraConfig
from ....structs.pose import Pose
from ....utils.registration import register_env
from ....utils.scene_utils import look_at
from ...base_env import BaseEnv

_ARCH_BLOCKS = [
    # (centre, half size): two legs and a top beam make the arch
    ((-0.03, 0, 0.015), (0.01, 0.02, 0.015)),
    ((0.03, 0, 0.015), (0.01, 0.02, 0.015)),
    ((0.0, 0, 0.035), (0.04, 0.02, 0.008)),
]


@register_env("FMBAssembly1Easy-v1", max_episode_steps=500)
class FMBAssembly1Env(BaseEnv):
    SUPPORTED_ROBOTS = ["panda"]

    def __init__(self, *args, robot_uids="panda", robot_init_qpos_noise=0.02, **kwargs):
        self.robot_init_qpos_noise = robot_init_qpos_noise
        super().__init__(*args, robot_uids=robot_uids, **kwargs)

    @property
    def _default_sensor_configs(self):
        pose = look_at(eye=[0.3, 0, 0.6], target=[-0.1, 0, 0.1])
        return [CameraConfig("base_camera", pose, 128, 128, np.pi / 2, 0.01, 100)]

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at([0.5, 0.5, 0.5], [0.0, 0.0, 0.1])
        return CameraConfig("render_camera", pose, 512, 512, 1, 0.01, 100)

    def _load_agent(self, options: dict):
        super()._load_agent(options, np.array([-0.615, 0, 0, 1, 0, 0, 0]))

    def _load_scene(self, options: dict):
        self.table_scene = TableSceneBuilder(self, robot_init_qpos_noise=self.robot_init_qpos_noise)
        self.table_scene.build()

        # the red assembly board with two studs the bridge's legs slot over
        bb = self.scene.create_actor_builder()
        bb.add_box_collision(half_size=[0.08, 0.06, 0.008])
        bb.add_box_visual(half_size=[0.08, 0.06, 0.008], color=[0.8, 0.1, 0.1, 1])
        for sx in (-1, 1):
            stud = [0.03 * sx, 0, 0.013, 1, 0, 0, 0]
            bb.add_box_collision(pose=stud, half_size=[0.006, 0.015, 0.005])
            bb.add_box_visual(pose=stud, half_size=[0.006, 0.015, 0.005], color=[0.7, 0.1, 0.1, 1])
        self.board_pos = np.array([0.05, 0.1])
        bb.set_initial_pose(np.array([*self.board_pos, 0.008, 1, 0, 0, 0]))
        self.board = bb.build_static(name="board")

        # the bridge: a nonconvex arch, one hull per block
        builder = self.scene.create_actor_builder()
        for c, h in _ARCH_BLOCKS:
            corners = np.array(
                [[c[0] + sx * h[0], c[1] + sy * h[1], c[2] + sz * h[2]]
                 for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                np.float32,
            )
            builder.add_convex_collision_from_mesh(hull_proxy(corners), color=[0.75, 0.75, 0.2, 1.0], density=600)
        builder.set_initial_pose([-0.08, -0.1, 0.001, 1, 0, 0, 0])
        self.bridge = builder.build(name="bridge")

        # the goal: the bridge seated over the studs
        dev = self.device
        self.goal_bridge_p = torch.as_tensor(
            np.array([*self.board_pos, 0.016], np.float32), device=dev
        ).expand(self.num_envs, 3)
        self._spawn_xy = torch.as_tensor(np.array([-0.08, -0.1], np.float32), device=dev)

    def _initialize_episode(self, env_idx: torch.Tensor, options: dict):
        self.table_scene.initialize(env_idx)
        rng = self._batched_episode_rng
        xy = rng.uniform(-0.03, 0.03, (2,)) + self._spawn_xy
        xyz = torch.cat([xy, torch.full_like(xy[:, :1], 0.001)], -1)
        qs = rng.quaternions(lock_x=True, lock_y=True)
        self.bridge.set_pose(Pose.create_from_pq(xyz, qs))

    def evaluate(self):
        placed = torch.linalg.vector_norm(self.bridge.pose.p - self.goal_bridge_p, dim=1) < 0.005
        return {"success": placed}

    def _get_obs_extra(self, info: dict):
        obs = dict(tcp_pose=self.agent.tcp_pose.raw_pose)
        if "state" in self.obs_mode:
            obs.update(
                bridge_pose=self.bridge.pose.raw_pose,
                goal_pos=self.goal_bridge_p,
                bridge_to_goal=self.goal_bridge_p - self.bridge.pose.p,
            )
        return obs

    def compute_dense_reward(self, obs, action, info):
        reach = torch.linalg.vector_norm(self.bridge.pose.p - self.agent.tcp_pose.p, dim=1)
        reward = 1 - torch.tanh(5 * reach)
        grasped = self.agent.is_grasping(self.bridge).to(torch.float32)
        reward = reward + grasped
        to_goal = torch.linalg.vector_norm(self.bridge.pose.p - self.goal_bridge_p, dim=1)
        reward = reward + 2 * (1 - torch.tanh(5 * to_goal)) * grasped
        return torch.where(info["success"], 6.0, reward)

    def compute_normalized_dense_reward(self, obs, action, info):
        return self.compute_dense_reward(obs, action, info) / 6.0
