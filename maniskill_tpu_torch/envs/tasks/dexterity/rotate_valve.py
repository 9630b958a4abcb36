"""RotateValveLevel{0-4}-v1 (counterpart of
maniskill_tpu/envs/tasks/dexterity/rotate_valve.py): a DClaw hand turns a
three-spoke valve by a level's angle.

Levels: 0 a quarter turn, 1-3 a half turn, 4 a full turn. From level 2 on
each env's spokes have their own length: the spoke capsules' collision
half-lengths are scaled per env by draws from ``np.random.RandomState(0)``,
whatever the seed (the spoke count stays fixed). Only the collision geoms
change, as in the JAX package, so the camera draws nominal spokes.
"""
from __future__ import annotations

import numpy as np
import torch

from ....building.articulation_builder import ArticulationBuilder, LinkSpec, ShapeSpec
from ....building.ground import build_ground
from ....physics.types import CAPSULE, CYLINDER, HINGE
from ....sensors.camera import CameraConfig
from ....structs.types import SceneConfig, SimConfig
from ....utils.registration import register_env
from ....utils.scene_utils import look_at
from ...base_env import BaseEnv


def _quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def _build_valve(scene, n_spokes=3, spoke_len=0.08):
    b = ArticulationBuilder(scene)
    b.add_link(LinkSpec("valve_base", None))
    shapes = []
    # the capsule's axis is its local z: a quarter turn about y lays it
    # along x, then the spoke's angle turns it about z
    rot_y = np.array([np.cos(np.pi / 4), 0, np.sin(np.pi / 4), 0])
    for i in range(n_spokes):
        ang = 2 * np.pi * i / n_spokes
        quat = np.array([np.cos(ang / 2), 0, 0, np.sin(ang / 2)])
        mid = (spoke_len / 2 * np.cos(ang), spoke_len / 2 * np.sin(ang), 0)
        shapes.append(ShapeSpec(CAPSULE, [0.015, spoke_len / 2, 0], mid, _quat_mul(quat, rot_y), friction=2.0,
                                color=(0.7, 0.1, 0.1, 1)))
    shapes.append(ShapeSpec(CYLINDER, [0.02, 0.02, 0], (0, 0, 0), friction=2.0, color=(0.4, 0.4, 0.4, 1)))
    b.add_link(LinkSpec("valve", "valve_base", HINGE, "valve_joint", axis=(0, 0, 1), damping=0.2, armature=0.005,
                        collisions=shapes, visuals=shapes))
    b.set_initial_pose(np.array([0, 0, 0.05, 1, 0, 0, 0]))
    return b.build("valve")


class RotateValveEnv(BaseEnv):
    SUPPORTED_ROBOTS = ["dclaw"]

    def __init__(self, *args, robot_uids="dclaw", robot_init_qpos_noise=0.02, valve_init_pos_noise=0.02,
                 difficulty_level: int = 0, **kwargs):
        if not isinstance(difficulty_level, int) or not (0 <= difficulty_level < 5):
            raise ValueError(f"Difficulty level must be an int within 0-4, got {difficulty_level}")
        self.robot_init_qpos_noise = robot_init_qpos_noise
        self.valve_init_pos_noise = valve_init_pos_noise
        self.difficulty_level = difficulty_level
        if difficulty_level == 0:
            self.success_threshold = np.pi / 2
        elif difficulty_level == 4:
            self.success_threshold = np.pi * 2
        else:
            self.success_threshold = np.pi
        super().__init__(*args, robot_uids=robot_uids, **kwargs)

    @property
    def _default_sim_config(self):
        return SimConfig(sim_freq=120, control_freq=60, scene_config=SceneConfig(solver_position_iterations=16))

    @property
    def _default_sensor_configs(self):
        pose = look_at(eye=[0.3, 0.3, 0.4], target=[0, 0, 0.1])
        return [CameraConfig("base_camera", pose, 128, 128, np.pi / 2, 0.01, 100)]

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at([0.35, 0.35, 0.5], [0, 0, 0.1])
        return CameraConfig("render_camera", pose, 512, 512, 1, 0.01, 100)

    def _load_agent(self, options: dict):
        super()._load_agent(options, np.array([0, 0, 0.30, 1, 0, 0, 0]))

    def _load_scene(self, options: dict):
        self.ground = build_ground(self.scene)
        self.valve = _build_valve(self.scene)
        self.valve_joint = self.valve.joints_map["valve_joint"]
        self.scene.register_extra("valve_start")

    def spoke_geom_ids(self):
        """The ids of the spokes' collision capsules."""
        return [g for g, gdef in enumerate(self.scene.mb.geoms)
                if gdef.name.startswith("valve:valve_col") and gdef.type == CAPSULE]

    def _after_reconfigure(self, options: dict):
        if self.difficulty_level >= 2:
            scales = np.random.RandomState(0).uniform(0.8, 1.2, size=(self.num_envs, 1)).astype(np.float32)
            gids = self.spoke_geom_ids()
            sizes = np.broadcast_to(self.scene.host_geom_size[..., gids, :], (self.num_envs, len(gids), 3)).copy()
            sizes[..., 1] *= scales
            self.scene.set_per_env_geom_sizes_by_id(gids, sizes)
        kf = self.agent.keyframes["rest"]
        self._rest_qpos = torch.as_tensor(np.asarray(kf.qpos, np.float32), device=self.device)

    def _initialize_episode(self, env_idx, options: dict):
        rng = self._batched_episode_rng
        noise = rng.normal(0.0, self.robot_init_qpos_noise, size=(self._rest_qpos.shape[0],))
        self.agent.reset(self._rest_qpos + noise)
        v0 = rng.uniform(-np.pi, np.pi)
        self.valve.set_qpos(v0[:, None])
        self.valve.set_qvel(torch.zeros(self.num_envs, 1, device=self.device))
        self.scene.set_extra("valve_start", v0, masked=True)

    @property
    def rotated_angle(self):
        return self.valve_joint.qpos[:, 0] - self.scene.get_extra("valve_start")

    def evaluate(self):
        rotated = self.rotated_angle
        return {"success": rotated >= self.success_threshold, "rotated": rotated}

    def _get_obs_extra(self, info: dict):
        return dict(valve_qpos=self.valve_joint.qpos, valve_qvel=self.valve_joint.qvel, rotated=info["rotated"])

    def compute_dense_reward(self, obs, action, info):
        progress = torch.clamp(info["rotated"] / self.success_threshold, -1.0, 1.0)
        spin = torch.clamp(self.valve_joint.qvel[:, 0], -2.0, 2.0) / 2.0
        return torch.where(info["success"], 3.0, progress * 2 + spin * 0.2)

    def compute_normalized_dense_reward(self, obs, action, info):
        return self.compute_dense_reward(obs, action, info) / 3.0


def _make_level(level):
    @register_env(f"RotateValveLevel{level}-v1", max_episode_steps=300)
    class RotateValveLevelEnv(RotateValveEnv):
        def __init__(self, *args, **kwargs):
            kwargs["difficulty_level"] = level
            super().__init__(*args, **kwargs)

    RotateValveLevelEnv.__name__ = f"RotateValveLevel{level}Env"
    return RotateValveLevelEnv


RotateValveLevel0Env = _make_level(0)
RotateValveLevel1Env = _make_level(1)
RotateValveLevel2Env = _make_level(2)
RotateValveLevel3Env = _make_level(3)
RotateValveLevel4Env = _make_level(4)
