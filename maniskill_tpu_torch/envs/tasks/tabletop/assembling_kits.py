"""AssemblingKits-v1 (counterpart of
maniskill_tpu/envs/tasks/tabletop/assembling_kits.py).

A kit board with a slot sits on the table; a piece of one of four block
shapes (square, bar, L, T), drawn per env, spawns nearby and must be set
into the slot. The piece is one actor with two hull slots whose clouds are
written per env through ``scene.set_per_env_hulls``; the board is a rim of
four static boxes. Success = the piece's xy within 2 cm of the slot, its
yaw within 4 degrees modulo the shape's symmetry, and seated (z under 3 mm
above the board). Sparse reward.
"""
from __future__ import annotations

import numpy as np
import torch

from ....building.cooking import hull_proxy
from ....scene_builder.table import TableSceneBuilder
from ....sensors.camera import CameraConfig
from ....structs.pose import Pose
from ....utils.geometry import rotation_conversions as rc
from ....utils.registration import register_env
from ....utils.scene_utils import look_at
from ...base_env import BaseEnv

# each shape: (cx, cy, hx, hy) unit blocks, z half = 1
_SHAPE_BLOCKS = {
    "square": [(0, 0, 1.0, 1.0)],
    "bar": [(0, 0, 1.6, 0.55)],
    "L": [(-0.3, 0, 0.5, 1.2), (0.45, -0.7, 0.85, 0.5)],
    "T": [(0, 0.6, 1.2, 0.45), (0, -0.35, 0.45, 0.75)],
}
_SHAPE_IDS = list(_SHAPE_BLOCKS)
# the yaw that maps each shape onto itself (L and T: none, so 2 pi)
_SYMMETRY = {"square": np.pi / 2, "bar": np.pi, "L": 2 * np.pi, "T": 2 * np.pi}
_SCALE = 0.022
_PIECE_HZ = 0.012
BOARD_HZ = 0.006


def piece_hulls(shape: str) -> np.ndarray:
    """(2, HULL_MAX_VERTS, 3) hull clouds of the piece's blocks (a one-block
    shape repeats its block)."""
    hulls = []
    for cx, cy, hx, hy in _SHAPE_BLOCKS[shape]:
        corners = np.array(
            [[cx + sx * hx, cy + sy * hy, sz * _PIECE_HZ / _SCALE]
             for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
            np.float32,
        ) * _SCALE
        hulls.append(hull_proxy(corners))
    while len(hulls) < 2:
        hulls.append(hulls[0])
    return np.stack(hulls[:2])


@register_env("AssemblingKits-v1", max_episode_steps=100)
class AssemblingKitsEnv(BaseEnv):
    SUPPORTED_ROBOTS = ["panda", "panda_wristcam"]
    SUPPORTED_REWARD_MODES = ("sparse", "none")

    def __init__(self, *args, robot_uids="panda", robot_init_qpos_noise=0.02, **kwargs):
        self.robot_init_qpos_noise = robot_init_qpos_noise
        super().__init__(*args, robot_uids=robot_uids, **kwargs)

    @property
    def _default_sensor_configs(self):
        pose = look_at(eye=[0.3, 0, 0.6], target=[-0.1, 0, 0.1])
        return [CameraConfig("base_camera", pose, 128, 128, np.pi / 2, 0.01, 100)]

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at([0.5, 0.6, 0.55], [0.0, 0.0, 0.1])
        return CameraConfig("render_camera", pose, 512, 512, 1, 0.01, 100)

    def _load_agent(self, options: dict):
        super()._load_agent(options, np.array([-0.615, 0, 0, 1, 0, 0, 0]))

    def _load_scene(self, options: dict):
        self.table_scene = TableSceneBuilder(self, robot_init_qpos_noise=self.robot_init_qpos_noise)
        self.table_scene.build()

        rng = self._main_rng or np.random.RandomState(2022)
        self.shape_ids = rng.randint(0, len(_SHAPE_IDS), size=self.num_envs)
        dev = self.device
        self.symmetry = torch.tensor([_SYMMETRY[_SHAPE_IDS[i]] for i in self.shape_ids],
                                     dtype=torch.float32, device=dev)

        # the board: a rim of four boxes around the slot, centred at the
        # board's origin
        self.slot_center = np.array([-0.12, 0.12])
        b = self.scene.create_actor_builder()
        bx, by, rim = 0.11, 0.11, 0.07
        for dx, dy, hx, hy in [
            (0, by - rim / 2 + 0.035, bx, rim / 2),
            (0, -(by - rim / 2 + 0.035), bx, rim / 2),
            (bx - rim / 2 + 0.035, 0, rim / 2, by),
            (-(bx - rim / 2 + 0.035), 0, rim / 2, by),
        ]:
            b.add_box_collision(pose=[dx, dy, 0, 1, 0, 0, 0], half_size=[hx, hy, BOARD_HZ])
            b.add_box_visual(pose=[dx, dy, 0, 1, 0, 0, 0], half_size=[hx, hy, BOARD_HZ],
                             color=[0.35, 0.25, 0.2, 1])
        b.set_initial_pose(np.array([*self.slot_center, BOARD_HZ, 1, 0, 0, 0]))
        self.kit = b.build_static(name="kit")

        # the piece: two hull slots, env 0's shape as the template
        cooked = {i: piece_hulls(_SHAPE_IDS[i]) for i in np.unique(self.shape_ids)}
        builder = self.scene.create_actor_builder()
        for hull in cooked[self.shape_ids[0]]:
            builder.add_convex_collision_from_mesh(hull, color=[0.9, 0.3, 0.3, 1.0], density=800)
        builder.set_initial_pose([0.05, -0.1, _PIECE_HZ, 1, 0, 0, 0])
        self.obj = builder.build(name="piece")
        self._pending_hulls = np.stack([cooked[i] for i in self.shape_ids])
        # the goal is the fixed slot frame
        self.goal_pos = torch.tensor([*self.slot_center, 0.0], dtype=torch.float32,
                                     device=dev).expand(self.num_envs, 3)
        self.goal_rot = torch.zeros(self.num_envs, device=dev)
        self._spawn_offset = torch.tensor([0.0, -0.18], device=dev)

    def _after_reconfigure(self, options: dict):
        self.scene.set_per_env_hulls(self.obj, self._pending_hulls)

    def _initialize_episode(self, env_idx: torch.Tensor, options: dict):
        self.table_scene.initialize(env_idx)
        rng = self._batched_episode_rng
        xy = rng.uniform(0.0, 0.12, (2,)) + self._spawn_offset
        xyz = torch.cat([xy, torch.full_like(xy[:, :1], _PIECE_HZ + 0.001)], -1)
        self.obj.set_pose(Pose.create_from_pq(xyz, rng.quaternions(lock_x=True, lock_y=True)))

    def evaluate(self):
        p = self.obj.pose.p
        pos_diff_norm = torch.linalg.vector_norm(self.goal_pos[:, :2] - p[:, :2], dim=1)
        # the yaw modulo the shape's symmetry
        mat = rc.quaternion_to_matrix(self.obj.pose.q)
        rot = torch.atan2(mat[:, 1, 0], mat[:, 0, 0])
        rot_diff = torch.remainder(torch.abs(rot - self.goal_rot), self.symmetry)
        rot_diff = torch.where(rot_diff > self.symmetry / 2, self.symmetry - rot_diff, rot_diff)
        pos_correct = pos_diff_norm < 2e-2
        rot_correct = rot_diff < np.deg2rad(4)
        in_slot = p[:, 2] < _PIECE_HZ + BOARD_HZ + 3e-3
        return {
            "pos_diff_norm": pos_diff_norm,
            "pos_correct": pos_correct,
            "rot_diff": rot_diff,
            "rot_correct": rot_correct,
            "in_slot": in_slot,
            "success": pos_correct & rot_correct & in_slot,
        }

    def _get_obs_extra(self, info: dict):
        obs = dict(tcp_pose=self.agent.tcp_pose.raw_pose)
        if "state" in self.obs_mode:
            p = self.obj.pose.p
            obs.update(
                obj_pose=self.obj.pose.raw_pose,
                tcp_to_obj_pos=p - self.agent.tcp_pose.p,
                goal_pos=self.goal_pos,
                goal_rot=self.goal_rot,
                obj_to_goal_pos=self.goal_pos - p,
            )
        return obs
