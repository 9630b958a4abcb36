"""DrawTriangle-v1 (counterpart of
maniskill_tpu/envs/tasks/drawing/draw_triangle.py).

A goal triangle outline (equilateral, side 0.3) lies on the canvas at a
random position and z-rotation; the stick robot must trace it. Success:
every one of the 153 reference points along the triangle (51 per edge) has
had the tip touch the canvas within ``THRESHOLD`` of it. The points, the
vertices and the hits are task extras.
"""
from __future__ import annotations

import numpy as np
import torch

from ....structs.pose import Pose
from ....utils.geometry import rotation_conversions as rc
from ....utils.registration import register_env
from .draw import TableTopFreeDrawEnv

N_EDGE_PTS = 51
N_REF = 3 * N_EDGE_PTS


@register_env("DrawTriangle-v1", max_episode_steps=300)
class DrawTriangleEnv(TableTopFreeDrawEnv):
    MAX_DOTS = 300
    THRESHOLD = 0.025
    SUPPORTED_REWARD_MODES = ("sparse", "none")

    def _load_scene(self, options: dict):
        super()._load_scene(options)
        # the goal outline: 3 thin boxes (side 0.3, height 0.001)
        side = 0.3
        radius = (side / 2) / np.sqrt(3)
        b = self.scene.create_actor_builder()
        for k in range(3):
            theta = np.pi / 2 + 2 * np.pi * k / 3
            c = np.array([radius * np.cos(theta), radius * np.sin(theta), 0.0])
            edge_angle = theta + np.pi / 2
            quat = np.array([np.cos(edge_angle / 2), 0, 0, np.sin(edge_angle / 2)])
            b.add_box_visual(
                pose=np.concatenate([c, quat]), half_size=[side / 2, 0.005, 0.0005], color=[0.1, 0.1, 0.6, 1.0]
            )
        b.set_initial_pose([0, 0, 0.011, 1, 0, 0, 0])
        self.goal_tri = b.build_kinematic(name="goal_tri")

        # the equilateral triangle's vertices in the goal frame
        theta = np.pi / 2 + 2 * np.pi * np.arange(3) / 3
        verts = np.stack([2 * radius * np.cos(theta), 2 * radius * np.sin(theta), np.zeros(3)], -1)
        self.original_verts = verts.astype(np.float32)

        self.scene.register_extra("tri_points", (N_REF, 2))
        self.scene.register_extra("tri_verts", (3, 3))
        self.scene.register_extra("ref_hit", (N_REF,), torch.bool)

    def _after_reconfigure(self, options: dict):
        super()._after_reconfigure(options)
        dev = self.device
        self._original_verts = torch.as_tensor(self.original_verts, device=dev)
        self._edge_t = torch.linspace(0.0, 1.0, N_EDGE_PTS, device=dev)

    def _initialize_episode(self, env_idx: torch.Tensor, options: dict):
        super()._initialize_episode(env_idx, options)
        rng = self._batched_episode_rng
        target_xy = rng.uniform(0.0, 0.02, (2,)) - 0.1
        target = torch.cat([target_xy, torch.full_like(target_xy[:, :1], 0.011)], -1)
        qs = rng.quaternions(lock_x=True, lock_y=True)
        self.goal_tri.set_pose(Pose.create_from_pq(target, qs))

        mats = rc.quaternion_to_matrix(qs)  # (B, 3, 3)
        verts = torch.einsum("bij,vj->bvi", mats, self._original_verts) + target[:, None, :]
        self.scene.set_extra("tri_verts", verts)
        # 51 points along each edge
        t = self._edge_t[None, :, None]
        pts = [
            verts[:, i, None, :2] * (1 - t) + verts[:, (i + 1) % 3, None, :2] * t for i in range(3)
        ]
        self.scene.set_extra("tri_points", torch.cat(pts, 1))  # (B, 153, 2)
        self.scene.set_extra("ref_hit", torch.zeros((), dtype=torch.bool, device=self.device))

    def _after_control_step(self):
        super()._after_control_step()
        self._mark_hits("tri_points")

    def evaluate(self):
        return {"success": self.scene.data.extras["ref_hit"].all(-1)}

    def compute_sparse_reward(self, obs, action, info):
        return info["success"].to(torch.float32)

    def _get_obs_extra(self, info: dict):
        obs = dict(tcp_pose=self.agent.tcp_pose.raw_pose)
        if "state" in self.obs_mode:
            verts = self.scene.data.extras["tri_verts"]
            obs.update(
                goal_pose=self.goal_tri.pose.raw_pose,
                tcp_to_verts_pos=(verts - self.agent.tcp_pose.p[:, None]).reshape(self.num_envs, -1),
                goal_pos=self.goal_tri.pose.p,
                vertices=verts.reshape(self.num_envs, -1),
            )
        return obs
