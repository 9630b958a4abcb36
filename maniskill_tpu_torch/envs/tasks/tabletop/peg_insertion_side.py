"""PegInsertionSide-v1 (counterpart of
maniskill_tpu/envs/tasks/tabletop/peg_insertion_side.py).

Grasp a box peg and insert it sideways into a hole in a kinematic block.
Each env has its own peg half-sizes and hole radius, drawn when the scene is
built: the peg's collision box takes its env's size and the block's four
collision plates their env's sizes and offsets through the scene's per-env
tables (``set_per_env_geom_sizes``, ``set_per_env_geom_pos``). The visual
geoms keep their nominal size, as in the JAX package (the renderer draws
visual geoms only).

Success: the peg head past the hole's entry plane and within its radius.
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

PLATE_HALF_THICKNESS = 0.04


@register_env("PegInsertionSide-v1", max_episode_steps=100)
class PegInsertionSideEnv(BaseEnv):
    SUPPORTED_ROBOTS = ["panda"]
    _clearance = 0.003

    def __init__(self, *args, robot_uids="panda", geometry_seed=None, **kwargs):
        # a fixed geometry_seed pins the geometry draw; by default each env
        # draws its geometry from its episode seed at every reconfigure
        self._geom_seed = geometry_seed
        if kwargs.get("reconfiguration_freq") is None:
            # one env reconfigures on every reset, batched envs keep theirs
            kwargs["reconfiguration_freq"] = 1 if kwargs.get("num_envs", 1) == 1 else 0
        super().__init__(*args, robot_uids=robot_uids, **kwargs)

    @property
    def _default_sensor_configs(self):
        pose = look_at([0, -0.3, 0.2], [0, 0, 0.1])
        return [CameraConfig("base_camera", pose, 128, 128, np.pi / 2, 0.01, 100)]

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at([0.5, -0.5, 0.8], [0.05, -0.1, 0.4])
        return CameraConfig("render_camera", pose, 512, 512, 1, 0.01, 100)

    def _load_agent(self, options: dict):
        super()._load_agent(options, np.array([-0.615, 0, 0, 1, 0, 0, 0]))

    def _draw_geometry(self):
        """(B,) peg half-lengths and radii, float32 host arrays."""
        B = self.num_envs
        if self._geom_seed is not None:
            rng = np.random.RandomState(self._geom_seed)
            return (rng.uniform(0.085, 0.125, B).astype(np.float32),
                    rng.uniform(0.015, 0.025, B).astype(np.float32))
        rngs = [np.random.RandomState(int(s) & 0x7FFFFFFF) for s in self._episode_seeds.tolist()]
        lengths = np.array([r.uniform(0.085, 0.125) for r in rngs], np.float32)
        radii = np.array([r.uniform(0.015, 0.025) for r in rngs], np.float32)
        return lengths, radii

    def _load_scene(self, options: dict):
        self.table_scene = TableSceneBuilder(self)
        self.table_scene.build()

        lengths, radii = self._draw_geometry()
        self._host_peg_half_sizes = np.stack([lengths, radii, radii], axis=1)
        self._host_hole_radii = radii + np.float32(self._clearance)
        dev = self.device
        self.peg_half_sizes = torch.as_tensor(self._host_peg_half_sizes, device=dev)
        self.box_hole_radii = torch.as_tensor(self._host_hole_radii, device=dev)

        # the peg at its nominal size; each env's size is set after the build
        b = self.scene.create_actor_builder()
        b.add_box_collision(half_size=(0.1, 0.02, 0.02), friction=1.0)
        b.add_box_visual(pose=np.array([0.05, 0, 0, 1, 0, 0, 0]), half_size=(0.05, 0.02, 0.02),
                         color=(0.84, 0.42, 0.21, 1))
        b.add_box_visual(pose=np.array([-0.05, 0, 0, 1, 0, 0, 0]), half_size=(0.05, 0.02, 0.02),
                         color=(0.93, 0.96, 0.98, 1))
        b.set_initial_pose(np.array([0, -0.15, 0.02, 1, 0, 0, 0]))
        self.peg = b.build("peg")

        # the block: four plates around a square hole along +x
        bb = self.scene.create_actor_builder()
        t, d, r = PLATE_HALF_THICKNESS, 0.1, 0.023
        for pos in ([0, r + t, 0], [0, -(r + t), 0], [0, 0, r + t], [0, 0, -(r + t)]):
            pose = np.array(pos + [1, 0, 0, 0], np.float64)
            bb.add_box_collision(pose=pose, half_size=(d, t, t + 2 * r), friction=1.0)
            bb.add_box_visual(pose=pose, half_size=(d, t, t + 2 * r), color=(1.0, 0.82, 0.54, 1))
        bb.set_initial_pose(np.array([0, 0.25, 0.1, 1, 0, 0, 0]))
        self.box = bb.build_kinematic("box_with_hole")

        self._identity_q = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
        self._grip_target = Pose(torch.tensor([-0.06, 0, 0, 1, 0, 0, 0], dtype=torch.float32, device=dev))
        # the peg's head in its frame, per env
        head = torch.zeros(self.num_envs, 3, device=dev)
        head[:, 0] = self.peg_half_sizes[:, 0]
        self.peg_head_offsets = Pose.create_from_pq(head, self._identity_q)

    def _after_reconfigure(self, options: dict):
        """Write each env's peg size and hole plates into the model."""
        B = self.num_envs
        peg_gid = int(self.peg.geom_ids[0])
        hole_gids = [int(g) for g in self.box.geom_ids if self.scene.mb.geoms[g].collision][:4]
        L = self._host_peg_half_sizes[:, 0]
        r = self._host_hole_radii
        t = np.full(B, PLATE_HALF_THICKNESS, np.float32)
        sizes, offsets = [self._host_peg_half_sizes], []
        # (axis: 0 = y, 1 = z; side): the plate's thin axis and its offset
        for axis, sign in ((0, 1), (0, -1), (1, 1), (1, -1)):
            sizes.append(np.stack([L, t, t + 2 * r] if axis == 0 else [L, t + 2 * r, t], axis=1))
            off = np.zeros((B, 3), np.float32)
            off[:, 1 + axis] = sign * (r + t)
            offsets.append(off)
        self.scene.set_per_env_geom_sizes_by_id([peg_gid] + hole_gids, np.stack(sizes, 1))
        self.scene.set_per_env_geom_pos(hole_gids, np.stack(offsets, 1))

    def _initialize_episode(self, env_idx: torch.Tensor, options: dict):
        self.table_scene.initialize(env_idx)
        rng = self._batched_episode_rng
        xy = torch.stack([rng.uniform(-0.1, 0.1), rng.uniform(-0.3, 0.0)], -1)
        pos = torch.cat([xy, self.peg_half_sizes[:, 2:3]], -1)
        ang = np.pi / 2 + rng.uniform(-np.pi / 3, np.pi / 3)
        zeros = torch.zeros_like(ang)
        quat = rc.axis_angle_to_quaternion(torch.stack([zeros, zeros, ang], -1))
        self.peg.set_pose(Pose.create_from_pq(pos, quat))

        bxy = torch.stack([rng.uniform(-0.05, 0.05), rng.uniform(0.2, 0.4)], -1)
        bpos = torch.cat([bxy, self.peg_half_sizes[:, 0:1]], -1)
        bang = np.pi / 2 + rng.uniform(-np.pi / 8, np.pi / 8)
        bquat = rc.axis_angle_to_quaternion(torch.stack([zeros, zeros, bang], -1))
        self.box.set_pose(Pose.create_from_pq(bpos, bquat))

    @property
    def peg_head_pose(self) -> Pose:
        return self.peg.pose * self.peg_head_offsets

    @property
    def box_hole_pose(self) -> Pose:
        return self.box.pose  # the hole is centred in the block's frame

    @property
    def goal_pose(self) -> Pose:
        return self.box.pose * self.peg_head_offsets.inv()

    def has_peg_inserted(self):
        p = (self.box_hole_pose.inv() * self.peg_head_pose).p
        r = self.box_hole_radii
        x_flag = p[:, 0] >= -0.015
        y_flag = (p[:, 1] >= -r) & (p[:, 1] <= r)
        z_flag = (p[:, 2] >= -r) & (p[:, 2] <= r)
        return x_flag & y_flag & z_flag, p

    def evaluate(self):
        success, peg_head_pos_at_hole = self.has_peg_inserted()
        return dict(success=success, peg_head_pos_at_hole=peg_head_pos_at_hole)

    def _get_obs_extra(self, info: dict):
        obs = dict(tcp_pose=self.agent.tcp.pose.raw_pose)
        if parse_obs_mode_to_struct(self.obs_mode)["use_state"]:
            obs.update(
                peg_pose=self.peg.pose.raw_pose,
                peg_half_size=self.peg_half_sizes,
                box_hole_pose=self.box_hole_pose.raw_pose,
                box_hole_radius=self.box_hole_radii,
            )
        return obs

    def compute_dense_reward(self, obs, action, info):
        tgt = self.peg.pose * self._grip_target
        reaching = 1 - torch.tanh(4.0 * torch.linalg.vector_norm(self.agent.tcp.pose.p - tgt.p, dim=1))
        is_grasped = self.agent.is_grasping(self.peg, max_angle=20)
        reward = reaching + is_grasped

        goal_inv = self.goal_pose.inv()
        head_yz = torch.linalg.vector_norm((goal_inv * self.peg_head_pose).p[:, 1:], dim=1)
        peg_yz = torch.linalg.vector_norm((goal_inv * self.peg.pose).p[:, 1:], dim=1)
        pre_insertion = 3 * (1 - torch.tanh(0.5 * (head_yz + peg_yz) + 4.5 * torch.maximum(head_yz, peg_yz)))
        reward = reward + pre_insertion * is_grasped
        pre_inserted = (head_yz < 0.01) & (peg_yz < 0.01)

        inside = (self.box_hole_pose.inv() * self.peg_head_pose).p
        insertion = 5 * (1 - torch.tanh(5.0 * torch.linalg.vector_norm(inside, dim=1)))
        reward = reward + insertion * (is_grasped & pre_inserted)
        return torch.where(info["success"], 10.0, reward)

    def compute_normalized_dense_reward(self, obs, action, info):
        return self.compute_dense_reward(obs, action, info) / 10.0
