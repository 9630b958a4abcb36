"""PickClutterYCB-v1 (counterpart of
maniskill_tpu/envs/tasks/tabletop/pick_clutter_ycb.py).

Each env holds a clutter of N_CLUTTER YCB objects (the procedural stand-ins)
and one of them is the target, with a goal site marking a point above it.
Like the reference this is a data-collection env: ``evaluate`` returns
all-false success and fail, and the only reward mode is "none".

N_CLUTTER actors with MAX_HULLS hull slots each; every actor draws its own
model per env (``scene.set_per_env_hulls``). The target's index per env is
the task extra ``target_idx``.
"""
from __future__ import annotations

import numpy as np
import torch

from ....building import actors
from ....building.actors import ycb
from ....scene_builder.table import TableSceneBuilder
from ....sensors.camera import CameraConfig
from ....structs.pose import Pose
from ....utils.registration import register_env
from ....utils.scene_utils import look_at
from ...base_env import BaseEnv
from ...utils.randomization import UniformPlacementSampler
from .pick_single_ycb import cook_models

N_CLUTTER = 4
MAX_HULLS = 4


@register_env("PickClutterYCB-v1", max_episode_steps=100)
class PickClutterYCBEnv(BaseEnv):
    SUPPORTED_ROBOTS = ["panda", "fetch"]
    SUPPORTED_REWARD_MODES = ("none",)

    def __init__(self, *args, robot_uids="panda", robot_init_qpos_noise=0.02, **kwargs):
        self.robot_init_qpos_noise = robot_init_qpos_noise
        self.all_model_ids = np.array(ycb.all_model_ids())
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

    def _load_scene(self, options: dict):
        self.scene_builder = TableSceneBuilder(self, robot_init_qpos_noise=self.robot_init_qpos_noise)
        self.scene_builder.build()

        rng = self._main_rng or np.random.RandomState(2022)
        ids = [rng.choice(self.all_model_ids, size=self.num_envs) for _ in range(N_CLUTTER)]
        cooked = cook_models(np.concatenate(ids), MAX_HULLS)  # each distinct model once
        self.objs = []
        self._pending = []  # (actor, (B, MAX_HULLS, V, 3) hulls, (B,) resting heights)
        for k, model_ids in enumerate(ids):
            builder = self.scene.create_actor_builder()
            for hull in cooked[model_ids[0]]:
                builder.add_convex_collision_from_mesh(hull, color=[0.75, 0.6, 0.4, 1.0])
            builder.set_initial_pose([0.6 + 0.2 * k, 0, 0.1, 1, 0, 0, 0])
            obj = builder.build(name=f"clutter_{k}")
            self.objs.append(obj)
            hulls = np.stack([cooked[m] for m in model_ids])
            self._pending.append((obj, hulls, -hulls.reshape(self.num_envs, -1, 3).min(axis=1)[:, 2]))

        self.goal_site = actors.build_sphere(
            self.scene,
            radius=0.01,
            color=[0, 1, 0, 1],
            name="goal_site",
            body_type="kinematic",
            add_collision=False,
            initial_pose=np.array([0, 0, 0.3, 1, 0, 0, 0]),
        )
        self._hidden_objects.append(self.goal_site)
        self.scene.register_extra("target_idx", (), torch.int32)
        dev = self.device
        self._placement_bounds = torch.tensor([[-0.15, -0.2], [0.1, 0.2]], device=dev)
        self._goal_scale = torch.tensor([0.3, 0.3, 1.0], device=dev)
        self._goal_lift = torch.tensor([0.0, 0.0, 0.1], device=dev)

    def _after_reconfigure(self, options: dict):
        self.object_zs = []
        for obj, hulls, zs in self._pending:
            self.scene.set_per_env_hulls(obj, hulls)
            self.object_zs.append(torch.as_tensor(zs, dtype=torch.float32, device=self.device))

    def _initialize_episode(self, env_idx: torch.Tensor, options: dict):
        self.scene_builder.initialize(env_idx)
        rng = self._batched_episode_rng
        sampler = UniformPlacementSampler(self._placement_bounds)
        for k, obj in enumerate(self.objs):
            xy = sampler.sample(rng, 0.08)
            xyz = torch.cat([xy, self.object_zs[k][:, None]], -1)
            obj.set_pose(Pose(torch.cat([xyz, rng.quaternions(lock_x=True, lock_y=True)], -1)))
        tgt = rng.randint(0, N_CLUTTER)
        self.scene.set_extra("target_idx", tgt)
        # the goal: a point above the target object
        goal = (self._object_pos(tgt) + rng.uniform(0.0, 0.2, (3,)) * self._goal_scale
                + self._goal_lift)
        ident = torch.zeros(self.num_envs, 4, device=self.device)
        ident[:, 0] = 1.0
        self.goal_site.set_pose(Pose(torch.cat([goal, ident], -1)))

    def _object_pos(self, idx: torch.Tensor) -> torch.Tensor:
        """(B, 3) position of object ``idx`` (B,) in each env."""
        obj_ps = torch.stack([o.pose.p for o in self.objs], 1)  # (B, K, 3)
        return torch.gather(obj_ps, 1, idx.long()[:, None, None].expand(-1, 1, 3))[:, 0]

    @property
    def target_pos(self):
        return self._object_pos(self.scene.get_extra("target_idx"))

    def evaluate(self):
        # as the reference: a data-collection env never succeeds or fails
        z = torch.zeros(self.num_envs, dtype=torch.bool, device=self.device)
        return {"success": z, "fail": z}

    def _get_obs_extra(self, info: dict):
        return dict(
            tcp_pose=self.agent.tcp_pose.raw_pose,
            goal_pos=self.goal_site.pose.p,
            target_pos=self.target_pos,
        )
