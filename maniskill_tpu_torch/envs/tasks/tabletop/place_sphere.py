"""PlaceSphere-v1 (counterpart of maniskill_tpu/envs/tasks/tabletop/place_sphere.py).

Pick the sphere and set it on top of a small open bin, a kinematic actor of
five boxes; success = the sphere on the bin, at rest and not grasped;
staged dense reward reach -> grasp and place -> release and still.
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


@register_env("PlaceSphere-v1", max_episode_steps=50)
class PlaceSphereEnv(BaseEnv):
    SUPPORTED_ROBOTS = ["panda"]

    radius = 0.02
    inner_side_half_len = 0.02
    short_side_half_size = 0.0025
    block_half_size = [0.0025, 0.025, 0.025]
    edge_block_half_size = [0.0025, 0.025, 0.005]

    def __init__(self, *args, robot_uids="panda", robot_init_qpos_noise=0.02, **kwargs):
        self.robot_init_qpos_noise = robot_init_qpos_noise
        super().__init__(*args, robot_uids=robot_uids, **kwargs)

    @property
    def _default_sensor_configs(self):
        pose = look_at(eye=[0.3, 0, 0.2], target=[-0.1, 0, 0])
        return [CameraConfig("base_camera", pose, 128, 128, np.pi / 2, 0.01, 100)]

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at([0.6, -0.2, 0.2], [0.0, 0.0, 0.2])
        return CameraConfig("render_camera", pose, 512, 512, 1, 0.01, 100)

    def _build_bin(self):
        """A floor plate and four low walls, one kinematic body."""
        builder = self.scene.create_actor_builder()
        bh, eh = self.block_half_size, self.edge_block_half_size
        dx = dy = bh[1] - bh[0]
        dz = eh[2] + bh[0]
        poses = [
            np.array([0, 0, 0, 1, 0, 0, 0]),
            np.array([-dx, 0, dz, 1, 0, 0, 0]),
            np.array([dx, 0, dz, 1, 0, 0, 0]),
            np.array([0, -dy, dz, 1, 0, 0, 0]),
            np.array([0, dy, dz, 1, 0, 0, 0]),
        ]
        half_sizes = [
            [bh[1], bh[2], bh[0]],
            eh,
            eh,
            [eh[1], eh[0], eh[2]],
            [eh[1], eh[0], eh[2]],
        ]
        for pose, half_size in zip(poses, half_sizes):
            builder.add_box_collision(pose=pose, half_size=half_size)
            builder.add_box_visual(pose=pose, half_size=half_size, color=(0.6, 0.5, 0.3, 1))
        builder.set_initial_pose(np.array([0.05, 0, self.block_half_size[0], 1, 0, 0, 0]))
        return builder.build_kinematic(name="bin")

    def _load_agent(self, options: dict):
        super()._load_agent(options, np.array([-0.615, 0, 0, 1, 0, 0, 0]))

    def _load_scene(self, options: dict):
        self.table_scene = TableSceneBuilder(self, robot_init_qpos_noise=self.robot_init_qpos_noise)
        self.table_scene.build()
        self.obj = actors.build_sphere(
            self.scene, radius=self.radius,
            color=np.array([12, 42, 160, 255]) / 255, name="sphere",
            body_type="dynamic",
            initial_pose=np.array([-0.08, 0, self.radius, 1, 0, 0, 0]),
        )
        self.bin = self._build_bin()
        dev = self.device
        self._identity_q = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
        self._bin_top = torch.tensor([0.0, 0.0, self.block_half_size[0] + self.radius], device=dev)

    def _initialize_episode(self, env_idx: torch.Tensor, options: dict):
        self.table_scene.initialize(env_idx)
        rng = self._batched_episode_rng
        x = rng.uniform(0.0, 1.0) * 0.05 - 0.1
        y = rng.uniform(0.0, 1.0) * 0.2 - 0.1
        self.obj.set_pose(Pose.create_from_pq(torch.stack([x, y, torch.full_like(x, self.radius)], -1), self._identity_q))
        bx = rng.uniform(0.0, 1.0) * 0.1
        by = rng.uniform(0.0, 1.0) * 0.2 - 0.1
        bpos = torch.stack([bx, by, torch.full_like(bx, self.block_half_size[0])], -1)
        self.bin.set_pose(Pose.create_from_pq(bpos, self._identity_q))

    def evaluate(self):
        offset = self.obj.pose.p - self.bin.pose.p
        xy_flag = torch.linalg.vector_norm(offset[..., :2], dim=1) <= 0.005
        z_flag = torch.abs(offset[..., 2] - self.radius - self.block_half_size[0]) <= 0.005
        is_obj_on_bin = xy_flag & z_flag
        is_obj_static = self.obj.is_static_check(lin_thresh=1e-2, ang_thresh=0.5)
        is_obj_grasped = self.agent.is_grasping(self.obj)
        return {
            "is_obj_grasped": is_obj_grasped,
            "is_obj_on_bin": is_obj_on_bin,
            "is_obj_static": is_obj_static,
            "success": is_obj_on_bin & is_obj_static & ~is_obj_grasped,
        }

    def _get_obs_extra(self, info: dict):
        obs = dict(
            is_grasped=info["is_obj_grasped"],
            tcp_pose=self.agent.tcp.pose.raw_pose,
            bin_pos=self.bin.pose.p,
        )
        if "state" in self.obs_mode:
            obs.update(
                obj_pose=self.obj.pose.raw_pose,
                tcp_to_obj_pos=self.obj.pose.p - self.agent.tcp.pose.p,
            )
        return obs

    def compute_dense_reward(self, obs, action, info):
        obj_pos = self.obj.pose.p
        reward = 2 * (1 - torch.tanh(5 * torch.linalg.vector_norm(self.agent.tcp.pose.p - obj_pos, dim=1)))

        bin_top = self.bin.pose.p + self._bin_top
        place_reward = 1 - torch.tanh(5.0 * torch.linalg.vector_norm(bin_top - obj_pos, dim=1))
        grasped = info["is_obj_grasped"]
        reward = torch.where(grasped, 4 + place_reward, reward)

        gripper_width = 0.08
        ungrasp = torch.sum(self.agent.robot.qpos[:, -2:], 1) / gripper_width
        ungrasp = torch.where(~grasped, 16.0, ungrasp)
        v = torch.linalg.vector_norm(self.obj.linear_velocity, dim=1)
        av = torch.linalg.vector_norm(self.obj.angular_velocity, dim=1)
        static_reward = 1 - torch.tanh(v * 10 + av)
        robot_static = self.agent.is_static(0.2).to(torch.float32)
        reward = torch.where(
            info["is_obj_on_bin"], 6 + (ungrasp + static_reward + robot_static) / 3.0, reward
        )
        return torch.where(info["success"], 13.0, reward)

    def compute_normalized_dense_reward(self, obs, action, info):
        return self.compute_dense_reward(obs, action, info) / 13.0
