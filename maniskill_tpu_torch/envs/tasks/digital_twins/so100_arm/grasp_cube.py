"""SO100GraspCube-v1 (counterpart of
maniskill_tpu/envs/tasks/digital_twins/so100_arm/grasp_cube.py).

Grasp a cube with the SO-ARM100 and return to the rest pose. With domain
randomization on: a cube half size and friction per env (host tables drawn
once at reconfigure), initial qpos noise, a fov offset, and a camera on a
kinematic mount re-posed in every env at each episode's start and before
every control step; an optional greenscreen overlay (``greenscreen_overlay_path``).

The mount's per-env generator lives in the registered extra ``cam_key``: an
int64 seed per env, from which each control step makes a ``BatchedRNG``,
draws the poses and writes the next seed, so a partial reset re-keys only
the envs it resets.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .....building import actors
from .....building.ground import build_ground
from .....sensors.camera import CameraConfig
from .....structs.pose import Pose
from .....structs.types import SimConfig
from .....utils.registration import register_env
from .....utils.scene_utils import look_at
from ....utils.observations import parse_obs_mode_to_struct
from ....utils.randomization.batched_rng import BatchedRNG
from ....utils.randomization.camera import batched_look_at
from ..base_env import BaseDigitalTwinEnv


@dataclasses.dataclass
class SO100GraspCubeDomainRandomizationConfig:
    """The reference's fields; the robot colour and the lighting are carried
    for parity and change nothing in the flat-shaded renderer."""

    initial_qpos_noise_scale: float = 0.02
    robot_color: Optional[Sequence[float]] = None
    randomize_lighting: bool = True
    max_camera_offset: Sequence[float] = (0.025, 0.025, 0.025)
    camera_target_noise: float = 1e-3
    camera_view_rot_noise: float = 5e-3
    camera_fov_noise: float = np.deg2rad(2)
    cube_half_size_range: Sequence[float] = (0.011, 0.014)
    cube_friction_mean: float = 0.3
    cube_friction_std: float = 0.05
    cube_friction_bounds: Sequence[float] = (0.1, 0.5)
    randomize_cube_color: bool = True


@register_env("SO100GraspCube-v1", max_episode_steps=64)
class SO100GraspCubeEnv(BaseDigitalTwinEnv):
    SUPPORTED_ROBOTS = ["so100"]
    SUPPORTED_OBS_MODES = ("none", "state", "state_dict", "rgb+segmentation", "rgb")

    def __init__(
        self,
        *args,
        robot_uids="so100",
        control_mode="pd_joint_target_delta_pos",
        greenscreen_overlay_path=None,
        domain_randomization_config=None,
        domain_randomization=True,
        base_camera_settings=dict(fov=52 * np.pi / 180, pos=[0.5, 0.3, 0.35], target=[0.3, 0.0, 0.1]),
        spawn_box_pos=[0.3, 0.05],
        spawn_box_half_size=0.1,
        **kwargs,
    ):
        self.domain_randomization = domain_randomization
        cfg = SO100GraspCubeDomainRandomizationConfig()
        if isinstance(domain_randomization_config, dict):
            cfg = dataclasses.replace(cfg, **domain_randomization_config)
        elif domain_randomization_config is not None:
            cfg = domain_randomization_config
        self.domain_randomization_config = cfg
        self.base_camera_settings = base_camera_settings
        self.spawn_box_pos = np.asarray(spawn_box_pos, np.float32)
        self.spawn_box_half_size = spawn_box_half_size
        if greenscreen_overlay_path is not None:
            self.rgb_overlay_paths = dict(base_camera=greenscreen_overlay_path)
        else:
            self.rgb_overlay_mode = "none"
        super().__init__(*args, robot_uids=robot_uids, control_mode=control_mode, **kwargs)

    @property
    def _default_sim_config(self):
        return SimConfig(sim_freq=100, control_freq=20)

    @property
    def _default_sensor_configs(self):
        fov = self.base_camera_settings["fov"]
        if self.domain_randomization:
            # one draw of a fixed seed: every env and every run share this fov
            # (the reference's comment says per env; its code draws one
            # scalar, which the port mirrors)
            rng = np.random.RandomState(2031)
            fov = fov + self.domain_randomization_config.camera_fov_noise * (2 * rng.rand() - 1)
        return [CameraConfig("base_camera", pose=np.array([0, 0, 0, 1, 0, 0, 0]), width=128, height=128,
                             fov=float(fov), near=0.01, far=100, mount=self.camera_mount)]

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at([0.5, 0.3, 0.35], [0.3, 0.0, 0.1])
        return CameraConfig("render_camera", pose, 512, 512, 52 * np.pi / 180, 0.01, 100)

    def _load_agent(self, options: dict):
        # the robot's base at the origin, turned +90 degrees about z
        super()._load_agent(options, np.array([0, 0, 0, np.cos(np.pi / 4), 0, 0, np.sin(np.pi / 4)]))

    def _load_scene(self, options: dict):
        self.ground = build_ground(self.scene)
        # the table's surface under the workspace, the robot's base at its edge
        b = self.scene.create_actor_builder()
        b.add_box_collision(half_size=[0.6, 0.4, 0.02], friction=1.0)
        b.add_box_visual(half_size=[0.6, 0.4, 0.02], color=[0.6, 0.55, 0.5, 1])
        b.set_initial_pose(np.array([0.25, 0, -0.021, 1, 0, 0, 0]))
        self.table = b.build_static("table")
        self.cube = actors.build_cube(self.scene, half_size=0.0125, color=[1, 0, 0, 1], name="cube",
                                      initial_pose=np.array([0.3, 0.05, 0.0125, 1, 0, 0, 0]))
        # the camera's kinematic mount, re-posed per env
        mb = self.scene.create_actor_builder()
        mb.set_initial_pose(look_at(self.base_camera_settings["pos"], self.base_camera_settings["target"]))
        self.camera_mount = mb.build_kinematic("camera_mount")

        dev = self.device
        self.rest_qpos = torch.tensor([0, 0, 0, np.pi / 2, np.pi / 2, 0], dtype=torch.float32, device=dev)
        self._spawn_center = torch.as_tensor(self.spawn_box_pos, device=dev)
        cfg = self.domain_randomization_config
        self._cam_base_pos = torch.tensor(self.base_camera_settings["pos"], dtype=torch.float32, device=dev)
        self._cam_target = torch.tensor(self.base_camera_settings["target"], dtype=torch.float32, device=dev)
        self._cam_max_offset = torch.tensor(cfg.max_camera_offset, dtype=torch.float32, device=dev)
        self.remove_object_from_greenscreen(self.cube)
        self.scene.register_extra("cam_key", (), torch.int64)

    def _after_reconfigure(self, options: dict):
        # per-env cube half sizes and frictions, from one numpy seed (the
        # first env's episode seed)
        cfg = self.domain_randomization_config
        B = self.num_envs
        rng = np.random.RandomState(int(self._episode_seeds[0]) & 0x7FFFFFFF)
        if self.domain_randomization:
            halfs = rng.uniform(*cfg.cube_half_size_range, B).astype(np.float32)
            frictions = np.clip(rng.normal(cfg.cube_friction_mean, cfg.cube_friction_std, B),
                                *cfg.cube_friction_bounds).astype(np.float32)
        else:
            halfs = np.full(B, 0.5 * sum(cfg.cube_half_size_range), np.float32)
            frictions = np.full(B, cfg.cube_friction_mean, np.float32)
        self.cube_half_sizes = torch.as_tensor(halfs, device=self.device)
        self.host_cube_half_sizes, self.host_cube_frictions = halfs, frictions
        gids = self.cube.geom_ids
        self.scene.set_per_env_geom_sizes_by_id(gids, np.tile(halfs[:, None, None], (1, len(gids), 3)))
        self.scene.set_per_env_friction(self.cube, frictions)
        super()._after_reconfigure(options)

    def sample_camera_poses(self, rng) -> Pose:
        """Camera poses in a box of half size ``max_camera_offset`` around the
        base position, looking at the base target plus noise. ``rng`` is a
        ``BatchedRNG`` (or anything with its ``uniform``/``normal``)."""
        cfg = self.domain_randomization_config
        eyes = self._cam_base_pos + rng.uniform(-1.0, 1.0, (3,)) * self._cam_max_offset
        targets = self._cam_target + rng.normal(0.0, cfg.camera_target_noise, (3,))
        return batched_look_at(eyes, targets)

    @staticmethod
    def _next_cam_keys(rng: BatchedRNG) -> torch.Tensor:
        return rng.randint(0, 2**31 - 1).to(torch.int64)

    def _initialize_episode(self, env_idx: torch.Tensor, options: dict):
        rng = self._batched_episode_rng
        noise = rng.normal(0.0, self.domain_randomization_config.initial_qpos_noise_scale, (6,))
        self.agent.reset(self.rest_qpos[None] + noise)
        xy = rng.uniform(-self.spawn_box_half_size, self.spawn_box_half_size, (2,)) + self._spawn_center
        pos = torch.cat([xy, self.cube_half_sizes[:, None]], -1)
        self.cube.set_pose(Pose(torch.cat([pos, rng.quaternions(lock_x=True, lock_y=True)], -1)))
        self.scene.set_extra("cam_key", self._next_cam_keys(rng))
        if self.domain_randomization:
            self.camera_mount.set_pose(self.sample_camera_poses(rng))

    def _before_control_step(self):
        if self.domain_randomization:
            rng = BatchedRNG(self.scene.get_extra("cam_key"))
            self.camera_mount.set_pose(self.sample_camera_poses(rng))
            self.scene.set_extra("cam_key", self._next_cam_keys(rng), masked=False)

    def _get_obs_agent(self):
        # qvel is too noisy on the real SO100
        return dict(qpos=self.agent.robot.qpos)

    @property
    def _arm_target_qpos(self):
        return self.agent.controller.controllers["arm"]._target_qpos()

    def _get_obs_extra(self, info: dict):
        obs = dict(dist_to_rest_qpos=self._arm_target_qpos[:, :-1] - self.rest_qpos[None, :-1])
        if parse_obs_mode_to_struct(self.obs_mode)["use_state"]:
            tcp = self.agent.tcp.pose.p
            obs.update(is_grasped=info["is_grasped"], obj_pose=self.cube.pose.raw_pose, tcp_pos=tcp,
                       tcp_to_obj_pos=self.cube.pose.p - tcp)
        return obs

    def evaluate(self):
        tcp_to_obj = torch.linalg.vector_norm(self.cube.pose.p - self.agent.tcp.pose.p, dim=-1)
        is_grasped = self.agent.is_grasping(self.cube)
        dist_rest = torch.linalg.vector_norm(self._arm_target_qpos[:, :-1] - self.rest_qpos[None, :-1], dim=-1)
        reached_rest = dist_rest < 0.2
        cube_lifted = self.cube.pose.p[..., -1] >= self.cube_half_sizes + 1e-3
        lf = self.scene.get_pairwise_contact_forces(self.agent.finger1_link, self.table)
        rf = self.scene.get_pairwise_contact_forces(self.agent.finger2_link, self.table)
        touching_table = ((torch.linalg.vector_norm(lf, dim=1) >= 1e-2)
                          | (torch.linalg.vector_norm(rf, dim=1) >= 1e-2))
        return dict(
            is_grasped=is_grasped,
            reached_object=tcp_to_obj < 0.03,
            distance_to_rest_qpos=dist_rest,
            touching_table=touching_table,
            cube_lifted=cube_lifted,
            success=cube_lifted & is_grasped & reached_rest,
        )

    def compute_dense_reward(self, obs, action, info):
        tcp_to_obj = torch.linalg.vector_norm(self.cube.pose.p - self.agent.tcp.pose.p, dim=1)
        grasped = info["is_grasped"].to(torch.float32)
        reward = 1 - torch.tanh(5 * tcp_to_obj) + grasped
        reward = reward + torch.exp(-2 * info["distance_to_rest_qpos"]) * grasped
        return reward - 2 * info["touching_table"].to(torch.float32)

    def compute_normalized_dense_reward(self, obs, action, info):
        return self.compute_dense_reward(obs, action, info) / 3
