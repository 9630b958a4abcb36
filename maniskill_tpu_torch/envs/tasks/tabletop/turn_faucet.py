"""TurnFaucet-v1 (counterpart of
maniskill_tpu/envs/tasks/tabletop/turn_faucet.py).

A procedural faucet: a fixed base (a cylinder column and a capsule spout)
and a lever handle on a hinge with damping, armature and friction loss.
Success = the handle turned past 90% of its joint range.
"""
from __future__ import annotations

import numpy as np
import torch

from ....building.articulation_builder import ArticulationBuilder, LinkSpec, ShapeSpec
from ....physics.types import BOX, CAPSULE, CYLINDER, HINGE
from ....scene_builder.table import TableSceneBuilder
from ....sensors.camera import CameraConfig
from ....utils.geometry import rotation_conversions as rc
from ....utils.registration import register_env
from ....utils.scene_utils import look_at
from ...base_env import BaseEnv
from ...utils.observations import parse_obs_mode_to_struct

HANDLE_RANGE = (0.0, np.pi / 2)


@register_env("TurnFaucet-v1", max_episode_steps=100)
class TurnFaucetEnv(BaseEnv):
    SUPPORTED_ROBOTS = ["panda"]
    target_frac = 0.9

    def __init__(self, *args, robot_uids="panda", robot_init_qpos_noise=0.02, **kwargs):
        self.robot_init_qpos_noise = robot_init_qpos_noise
        super().__init__(*args, robot_uids=robot_uids, **kwargs)

    @property
    def _default_sensor_configs(self):
        pose = look_at([-0.4, 0.3, 0.3], [0.05, 0, 0.1])
        return [CameraConfig("base_camera", pose, 128, 128, np.pi / 2, 0.01, 100)]

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at([0.5, 0.5, 0.6], [0.05, 0, 0.2])
        return CameraConfig("render_camera", pose, 512, 512, 1, 0.01, 100)

    def _load_agent(self, options: dict):
        super()._load_agent(options, np.array([-0.615, 0, 0, 1, 0, 0, 0]))

    def _load_scene(self, options: dict):
        self.table_scene = TableSceneBuilder(self, robot_init_qpos_noise=self.robot_init_qpos_noise)
        self.table_scene.build()

        b = ArticulationBuilder(self.scene)
        grey = (0.7, 0.7, 0.75, 1)
        column = ShapeSpec(CYLINDER, [0.03, 0.07, 0], (0, 0, 0.07), friction=1.0, color=grey)
        spout = ShapeSpec(
            CAPSULE, [0.015, 0.05, 0], (0.05, 0, 0.16),
            np.array([np.cos(np.pi / 4), 0, np.sin(np.pi / 4), 0]), friction=1.0, color=grey,
        )
        b.add_link(LinkSpec("faucet_base", None, collisions=[column, spout], visuals=[column, spout]))
        lever = ShapeSpec(BOX, (0.05, 0.012, 0.012), (0.05, 0, 0), friction=1.0, color=(0.85, 0.2, 0.2, 1))
        b.add_link(LinkSpec(
            "handle", "faucet_base", HINGE, "handle_joint",
            origin_pos=(0, 0, 0.17), axis=(0, 0, 1), limit=HANDLE_RANGE,
            damping=0.5, armature=0.01, frictionloss=0.1,
            collisions=[lever], visuals=[lever],
        ))
        b.set_initial_pose(np.array([0.1, 0.0, 0.0, 1, 0, 0, 0]))
        self.faucet = b.build("faucet")
        self.handle_joint = self.faucet.joints_map["handle_joint"]
        self.handle_link = self.faucet.links_map["handle"]
        self._tip_offset = torch.tensor([0.1, 0.0, 0.0], device=self.device)

    def _initialize_episode(self, env_idx: torch.Tensor, options: dict):
        self.table_scene.initialize(env_idx)
        q0 = self._batched_episode_rng.uniform(0.0, 0.05)
        self.faucet.set_qpos(q0[:, None])
        self.faucet.set_qvel(torch.zeros(self.num_envs, 1, device=self.device))

    @property
    def handle_tip_pos(self):
        p = self.handle_link.pose
        return p.p + rc.quaternion_apply(p.q, self._tip_offset)

    def evaluate(self):
        frac = self.handle_joint.qpos[:, 0] / (HANDLE_RANGE[1] - HANDLE_RANGE[0])
        return {"success": frac >= self.target_frac, "open_frac": frac}

    def _get_obs_extra(self, info: dict):
        obs = dict(
            tcp_pose=self.agent.tcp.pose.raw_pose,
            handle_tip=self.handle_tip_pos,
            open_frac=info["open_frac"],
        )
        if parse_obs_mode_to_struct(self.obs_mode)["use_state"]:
            obs.update(handle_qpos=self.handle_joint.qpos)
        return obs

    def compute_dense_reward(self, obs, action, info):
        reach = 1 - torch.tanh(5 * torch.linalg.vector_norm(self.handle_tip_pos - self.agent.tcp.pose.p, dim=1))
        turn = 2 * torch.clamp(info["open_frac"] / self.target_frac, 0.0, 1.0)
        return torch.where(info["success"], 4.0, reach + turn)

    def compute_normalized_dense_reward(self, obs, action, info):
        return self.compute_dense_reward(obs, action, info) / 4.0
