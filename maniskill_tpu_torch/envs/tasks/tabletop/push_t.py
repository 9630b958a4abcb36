"""PushT-v1 (counterpart of maniskill_tpu/envs/tasks/tabletop/push_t.py).

Push a T-shaped block (one body of two boxes) onto a kinematic target T
(position and yaw). Coverage is measured on a fixed grid of points of the T
footprint: the share of the block's points within ``point_tol`` of some
point of the target; success at ``coverage_thresh`` or more.
"""
from __future__ import annotations

import numpy as np
import torch

from ....scene_builder.table import TableSceneBuilder
from ....sensors.camera import CameraConfig
from ....structs.pose import Pose
from ....utils.geometry import rotation_conversions as rc
from ....utils.registration import register_env
from ....utils.scene_utils import look_at
from ...base_env import BaseEnv
from ...utils.observations import parse_obs_mode_to_struct

# T dimensions: bar 2*0.1 x 2*0.03, stem 2*0.03 x 2*0.1
BAR_HALF = (0.1, 0.03)
STEM_HALF = (0.03, 0.1)
TEE_HALF_H = 0.02


def _tee_points():
    """(P, 2) fixed sample points covering the T footprint (local frame)."""
    pts = [[x, y + STEM_HALF[1]]
           for x in np.linspace(-BAR_HALF[0], BAR_HALF[0], 10)
           for y in np.linspace(-BAR_HALF[1], BAR_HALF[1], 3)]
    pts += [[x, y - BAR_HALF[1]]
            for x in np.linspace(-STEM_HALF[0], STEM_HALF[0], 3)
            for y in np.linspace(-STEM_HALF[1], STEM_HALF[1], 8)]
    return np.asarray(pts, np.float32)


@register_env("PushT-v1", max_episode_steps=100)
class PushTEnv(BaseEnv):
    SUPPORTED_ROBOTS = ["panda"]
    coverage_thresh = 0.9
    point_tol = 0.02

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

    def _build_tee(self, name, color, body_type, z):
        """The T; only the dynamic one collides."""
        b = self.scene.create_actor_builder()
        bar_pose = np.array([0.0, STEM_HALF[1], 0, 1, 0, 0, 0])
        stem_pose = np.array([0.0, -BAR_HALF[1], 0, 1, 0, 0, 0])
        dynamic = body_type == "dynamic"
        if dynamic:
            b.add_box_collision(bar_pose, (BAR_HALF[0], BAR_HALF[1], TEE_HALF_H), friction=0.6)
            b.add_box_collision(stem_pose, (STEM_HALF[0], STEM_HALF[1], TEE_HALF_H), friction=0.6)
        b.add_box_visual(bar_pose, (BAR_HALF[0], BAR_HALF[1], TEE_HALF_H), color=color)
        b.add_box_visual(stem_pose, (STEM_HALF[0], STEM_HALF[1], TEE_HALF_H), color=color)
        b.set_initial_pose(np.array([0, 0, z, 1, 0, 0, 0]))
        return b.build(name) if dynamic else b.build_kinematic(name)

    def _load_scene(self, options: dict):
        self.table_scene = TableSceneBuilder(self, robot_init_qpos_noise=self.robot_init_qpos_noise)
        self.table_scene.build()
        self.tee = self._build_tee("tee", (0.3, 0.3, 0.9, 1), "dynamic", TEE_HALF_H)
        self.target_tee = self._build_tee("target_tee", (0.9, 0.2, 0.2, 1), "kinematic", 1e-3)
        self._points = torch.as_tensor(_tee_points(), device=self.device)  # (P, 2)

    def _initialize_episode(self, env_idx: torch.Tensor, options: dict):
        self.table_scene.initialize(env_idx)
        rng = self._batched_episode_rng
        xy = rng.uniform(-0.1, 0.1, (2,))
        ang = rng.uniform(-np.pi, np.pi)
        zeros = torch.zeros_like(ang)
        q = rc.axis_angle_to_quaternion(torch.stack([zeros, zeros, ang], -1))
        xyz = torch.cat([xy, torch.full_like(xy[:, :1], TEE_HALF_H)], -1)
        self.tee.set_pose(Pose.create_from_pq(xyz, q))

        txy = rng.uniform(-0.15, 0.15, (2,))
        tang = rng.uniform(-np.pi, np.pi)
        tq = rc.axis_angle_to_quaternion(torch.stack([zeros, zeros, tang], -1))
        txyz = torch.cat([txy, torch.full_like(txy[:, :1], 1e-3)], -1)
        self.target_tee.set_pose(Pose.create_from_pq(txyz, tq))

    def _world_points(self, actor):
        """The T's footprint points moved by the actor's planar pose: (B, P, 2)."""
        p = actor.pose
        yaw_mat = rc.quaternion_to_matrix(p.q)[..., :2, :2]  # (B, 2, 2)
        return p.p[:, None, :2] + torch.einsum("bij,pj->bpi", yaw_mat, self._points)

    def coverage(self):
        obj = self._world_points(self.tee)  # (B, P, 2)
        tgt = self._world_points(self.target_tee)
        d2 = torch.sum((obj[:, :, None, :] - tgt[:, None, :, :]) ** 2, -1)
        nearest = torch.sqrt(torch.amin(d2, 2))  # (B, P)
        return torch.mean((nearest < self.point_tol).to(torch.float32), 1)

    def evaluate(self):
        cov = self.coverage()
        return {"success": cov >= self.coverage_thresh, "coverage": cov}

    def _get_obs_extra(self, info: dict):
        obs = dict(tcp_pose=self.agent.tcp.pose.raw_pose)
        if parse_obs_mode_to_struct(self.obs_mode)["use_state"]:
            obs.update(
                obj_pose=self.tee.pose.raw_pose,
                goal_pose=self.target_tee.pose.raw_pose,
                coverage=info["coverage"],
            )
        return obs

    def compute_dense_reward(self, obs, action, info):
        tcp_to_obj = torch.linalg.vector_norm(self.tee.pose.p - self.agent.tcp.pose.p, dim=1)
        reward = 1 - torch.tanh(5 * tcp_to_obj) + 2 * info["coverage"]
        return torch.where(info["success"], 4.0, reward)

    def compute_normalized_dense_reward(self, obs, action, info):
        return self.compute_dense_reward(obs, action, info) / 4.0
