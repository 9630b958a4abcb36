"""StackPyramid-v1 (counterpart of
maniskill_tpu/envs/tasks/tabletop/stack_pyramid.py).

Put the red cube A beside the green cube B, then the blue cube C on top of
both. Success = C on A and on B, A beside B, each placed cube at rest and
nothing grasped. Sparse reward only; the default robot carries a wrist
camera.
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
from ...utils.randomization import UniformPlacementSampler


@register_env("StackPyramid-v1", max_episode_steps=250)
class StackPyramidEnv(BaseEnv):
    SUPPORTED_ROBOTS = ["panda_wristcam", "panda"]
    SUPPORTED_REWARD_MODES = ("none", "sparse")

    cube_half_size = 0.02

    def __init__(self, *args, robot_uids="panda_wristcam", robot_init_qpos_noise=0.02, **kwargs):
        self.robot_init_qpos_noise = robot_init_qpos_noise
        super().__init__(*args, robot_uids=robot_uids, **kwargs)

    @property
    def _default_sensor_configs(self):
        pose = look_at(eye=[0.3, 0, 0.4], target=[-0.05, 0, 0.1])
        return [CameraConfig("base_camera", pose, 128, 128, np.pi / 2, 0.01, 100)]

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at([0.6, 0.7, 0.6], [0.0, 0.0, 0.35])
        return CameraConfig("render_camera", pose, 512, 512, 1, 0.01, 100)

    def _load_agent(self, options: dict):
        super()._load_agent(options, np.array([-0.615, 0, 0, 1, 0, 0, 0]))

    def _load_scene(self, options: dict):
        self.table_scene = TableSceneBuilder(self, robot_init_qpos_noise=self.robot_init_qpos_noise)
        self.table_scene.build()
        colors = {"A": [1, 0, 0, 1], "B": [0, 1, 0, 1], "C": [0, 0, 1, 1]}
        for key, color in colors.items():
            setattr(self, f"cube{key}", actors.build_cube(
                self.scene, half_size=self.cube_half_size, color=color, name=f"cube{key}",
                initial_pose=np.array([0, 0, 0.2, 1, 0, 0, 0]),
            ))
        self._placement_bounds = torch.tensor([[-0.1, -0.2], [0.1, 0.2]], device=self.device)

    def _initialize_episode(self, env_idx: torch.Tensor, options: dict):
        self.table_scene.initialize(env_idx)
        rng = self._batched_episode_rng
        sampler = UniformPlacementSampler(self._placement_bounds)
        radius = float(np.linalg.norm([0.02, 0.02]))
        for cube in (self.cubeA, self.cubeB, self.cubeC):
            xy = sampler.sample(rng, radius)
            q = rng.quaternions(lock_x=True, lock_y=True)
            cube.set_pose(Pose.create_from_pq(torch.cat([xy, torch.full_like(xy[:, :1], 0.02)], -1), q))

    def evaluate(self):
        pos_A, pos_B, pos_C = self.cubeA.pose.p, self.cubeB.pose.p, self.cubeC.pose.p
        reach = float(np.linalg.norm([2 * self.cube_half_size] * 2)) + 0.005

        def pair_success(offset, cube, on_top: bool):
            ok = torch.linalg.vector_norm(offset[..., :2], dim=1) <= reach
            if on_top:
                ok = ok & (torch.abs(offset[..., 2]) > 0.02)
            is_static = cube.is_static_check(lin_thresh=1e-2, ang_thresh=0.5)
            return ok & is_static & ~self.agent.is_grasping(cube)

        success_A_B = pair_success(pos_A - pos_B, self.cubeA, on_top=False)
        success_C_B = pair_success(pos_B - pos_C, self.cubeC, on_top=True)
        success_C_A = pair_success(pos_A - pos_C, self.cubeC, on_top=True)
        return {"success": success_A_B & success_C_B & success_C_A}

    def _get_obs_extra(self, info: dict):
        obs = dict(tcp_pose=self.agent.tcp_pose.raw_pose)
        if "state" in self.obs_mode:
            tcp_p = self.agent.tcp_pose.p
            obs.update(
                cubeA_pose=self.cubeA.pose.raw_pose,
                cubeB_pose=self.cubeB.pose.raw_pose,
                cubeC_pose=self.cubeC.pose.raw_pose,
                tcp_to_cubeA_pos=self.cubeA.pose.p - tcp_p,
                tcp_to_cubeB_pos=self.cubeB.pose.p - tcp_p,
                tcp_to_cubeC_pos=self.cubeC.pose.p - tcp_p,
            )
        return obs
