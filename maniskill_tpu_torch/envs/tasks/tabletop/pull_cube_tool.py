"""PullCubeTool-v1 (counterpart of
maniskill_tpu/envs/tasks/tabletop/pull_cube_tool.py).

An L-shaped tool (one body of two boxes) lies within the arm's reach; the
cube lies beyond it. Use the tool's hook to pull the cube in; success = the
cube's xy within 0.6 m of the robot base; staged dense reward reach and
grasp the tool -> place the hook -> pull.
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


@register_env("PullCubeTool-v1", max_episode_steps=100)
class PullCubeToolEnv(BaseEnv):
    SUPPORTED_ROBOTS = ["panda"]

    goal_radius = 0.3
    cube_half_size = 0.02
    handle_length = 0.2
    hook_length = 0.05
    width = 0.05
    height = 0.05
    cube_size = 0.02
    arm_reach = 0.35

    def __init__(self, *args, robot_uids="panda", robot_init_qpos_noise=0.02, **kwargs):
        self.robot_init_qpos_noise = robot_init_qpos_noise
        super().__init__(*args, robot_uids=robot_uids, **kwargs)

    @property
    def _default_sensor_configs(self):
        pose = look_at(eye=[0.3, 0, 0.5], target=[-0.1, 0, 0.1])
        return [CameraConfig("base_camera", pose, 128, 128, np.pi / 2, 0.01, 100)]

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at([0.6, 0.7, 0.6], [0.0, 0.0, 0.35])
        return CameraConfig("render_camera", pose, 512, 512, 1, 0.01, 100)

    def _load_agent(self, options: dict):
        super()._load_agent(options, np.array([-0.615, 0, 0, 1, 0, 0, 0]))

    def _build_l_shaped_tool(self):
        """The handle along local x and the hook at its end along +y."""
        hl, hk, w, h = self.handle_length, self.hook_length, self.width, self.height
        b = self.scene.create_actor_builder()
        b.add_box_collision([hl / 2, 0, 0, 1, 0, 0, 0], [hl / 2, w / 2, h / 2], density=500)
        b.add_box_visual([hl / 2, 0, 0, 1, 0, 0, 0], [hl / 2, w / 2, h / 2], color=[1, 0, 0, 1])
        b.add_box_collision([hl - hk / 2, w, 0, 1, 0, 0, 0], [hk / 2, w, h / 2])
        b.add_box_visual([hl - hk / 2, w, 0, 1, 0, 0, 0], [hk / 2, w, h / 2], color=[1, 0, 0, 1])
        b.set_initial_pose([-0.2, -0.2, h / 2, 1, 0, 0, 0])
        return b.build(name="l_shape_tool")

    def _load_scene(self, options: dict):
        self.scene_builder = TableSceneBuilder(self, robot_init_qpos_noise=self.robot_init_qpos_noise)
        self.scene_builder.build()
        self.cube = actors.build_cube(
            self.scene,
            half_size=self.cube_half_size,
            color=np.array([12, 42, 160, 255]) / 255,
            name="cube",
            initial_pose=np.array([0.3, 0, self.cube_size / 2, 1, 0, 0, 0]),
        )
        self.l_shape_tool = self._build_l_shaped_tool()
        dev = self.device

        def t(v):
            return torch.tensor(v, dtype=torch.float32, device=dev)

        self._identity_q = t([1.0, 0.0, 0.0, 0.0])
        self._tool_grasp_offset = t([0.02, 0, 0])
        self._hook_offset = t([-(self.hook_length + self.cube_half_size), -0.067, 0])
        self._workspace_offset = t([0.05, 0, 0])
        self._cube_start = t([self.arm_reach + 0.1, 0, self.cube_size / 2])

    def _initialize_episode(self, env_idx: torch.Tensor, options: dict):
        self.scene_builder.initialize(env_idx)
        rng = self._batched_episode_rng
        tool_xy = -rng.uniform(0.0, 0.2, (2,)) - 0.1
        tool_xyz = torch.cat([tool_xy, torch.full_like(tool_xy[:, :1], self.height / 2)], -1)
        self.l_shape_tool.set_pose(Pose.create_from_pq(tool_xyz, self._identity_q))

        cx = self.arm_reach + rng.uniform(0.0, self.handle_length) - 0.3
        cy = rng.uniform(0.0, 0.3) - 0.25
        cube_xyz = torch.stack([cx, cy, torch.full_like(cx, self.cube_size / 2 + 0.015)], -1)
        cube_q = rng.quaternions(lock_x=True, lock_y=True, bounds=(-np.pi / 6, np.pi / 6))
        self.cube.set_pose(Pose.create_from_pq(cube_xyz, cube_q))

    def _get_obs_extra(self, info: dict):
        obs = dict(tcp_pose=self.agent.tcp_pose.raw_pose)
        if "state" in self.obs_mode:
            obs.update(
                cube_pose=self.cube.pose.raw_pose,
                tool_pose=self.l_shape_tool.pose.raw_pose,
            )
        return obs

    def evaluate(self):
        cube_pos = self.cube.pose.p
        base_pos = self.agent.robot.links[0].pose.p
        dist = torch.linalg.vector_norm(cube_pos[:, :2] - base_pos[:, :2], dim=1)
        return {"success": dist < 0.6}

    def compute_dense_reward(self, obs, action, info):
        tcp_pos = self.agent.tcp_pose.p
        cube_pos = self.cube.pose.p
        tool_pos = self.l_shape_tool.pose.p
        base_pos = self.agent.robot.links[0].pose.p

        # stage 1: reach and grasp the tool's handle
        tcp_to_tool = torch.linalg.vector_norm(tcp_pos - (tool_pos + self._tool_grasp_offset), dim=1)
        reward = 2.0 * (1 - torch.tanh(5.0 * tcp_to_tool))
        is_grasping = self.agent.is_grasping(self.l_shape_tool, max_angle=20).to(torch.float32)
        reward = reward + 2.0 * is_grasping

        # stage 2: the hook behind the cube
        tool_positioning = torch.linalg.vector_norm(tool_pos - (cube_pos + self._hook_offset), dim=1)
        reward = reward + 1.5 * (1 - torch.tanh(3.0 * tool_positioning)) * is_grasping
        tool_positioned = (tool_positioning < 0.05).to(torch.float32)

        # stage 3: pull toward the workspace
        workspace_target = base_pos + self._workspace_offset
        cube_to_ws = torch.linalg.vector_norm(cube_pos - workspace_target, dim=1)
        initial = torch.linalg.vector_norm(self._cube_start - workspace_target, dim=1)
        pulling_progress = (initial - cube_to_ws) / torch.clamp(initial, min=1e-6)
        reward = reward + 3.0 * pulling_progress * tool_positioned * is_grasping

        reward = torch.where(cube_pos[:, 0] > self.arm_reach + 0.15, reward - 2.0, reward)
        return torch.where(info["success"], reward + 5.0, reward)

    def compute_normalized_dense_reward(self, obs, action, info):
        return self.compute_dense_reward(obs=obs, action=action, info=info) / 5.0
