"""PickSingleYCB-v1 (counterpart of
maniskill_tpu/envs/tasks/tabletop/pick_single_ycb.py).

Each env holds a different object drawn from the YCB model list (the
procedural stand-ins of building/actors/ycb.py); it spawns flat on the
table with a random yaw and must be moved to a random 3D goal. Success =
object within ``goal_thresh`` of the goal AND the robot static.

One actor with MAX_HULLS convex hull slots carries every env's object:
``scene.set_per_env_hulls`` writes each env's hull vertex table and
``set_per_env_body_mass`` its mass after the model is built. The body's
inertia stays the template's (env 0's object's AABB box), as in the JAX
package.
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

MAX_HULLS = 8


def cook_models(model_ids, max_parts: int) -> dict:
    """model id -> (max_parts, V, 3) hull proxies of each distinct id, a
    model with fewer parts padded by repeating its part 0."""
    cooked = {}
    for mid in np.unique(model_ids):
        parts = ycb.cooked_hulls(mid, max_parts=max_parts)
        parts = parts + [parts[0]] * (max_parts - len(parts))
        cooked[mid] = np.stack(parts[:max_parts])
    return cooked


@register_env("PickSingleYCB-v1", max_episode_steps=50)
class PickSingleYCBEnv(BaseEnv):
    SUPPORTED_ROBOTS = ["panda", "panda_wristcam"]

    goal_thresh = 0.025

    def __init__(self, *args, robot_uids="panda_wristcam", robot_init_qpos_noise=0.02, num_envs=1,
                 reconfiguration_freq=None, **kwargs):
        self.robot_init_qpos_noise = robot_init_qpos_noise
        self.all_model_ids = np.array(ycb.all_model_ids())
        if reconfiguration_freq is None:
            # one env draws a new object every episode, as the reference;
            # batched envs keep theirs
            reconfiguration_freq = 1 if num_envs == 1 else 0
        super().__init__(*args, robot_uids=robot_uids, num_envs=num_envs,
                         reconfiguration_freq=reconfiguration_freq, **kwargs)

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
        self.table_scene = TableSceneBuilder(self, robot_init_qpos_noise=self.robot_init_qpos_noise)
        self.table_scene.build()

        rng = self._main_rng or np.random.RandomState(2022)
        self.model_ids = rng.choice(self.all_model_ids, size=self.num_envs, replace=True)
        cooked = cook_models(self.model_ids, MAX_HULLS)

        # one actor with MAX_HULLS hull slots; env 0's model is the template
        builder = self.scene.create_actor_builder()
        for hull in cooked[self.model_ids[0]]:
            builder.add_convex_collision_from_mesh(hull, density=1000.0, color=[0.82, 0.62, 0.35, 1.0])
        builder.set_initial_pose([0, 0, 0.1, 1, 0, 0, 0])
        self.obj = builder.build(name="ycb_object")

        hulls = np.stack([cooked[m] for m in self.model_ids])  # (B, K, V, 3)
        self._pending_hulls = hulls
        # per-env resting height and mass from the hull AABB (~40% fill)
        lo = hulls.reshape(self.num_envs, -1, 3).min(axis=1)
        hi = hulls.reshape(self.num_envs, -1, 3).max(axis=1)
        self.object_zs = torch.as_tensor(-lo[:, 2], dtype=torch.float32, device=self.device)
        vol = np.prod(np.maximum(hi - lo, 1e-4), axis=1)
        dens = np.array([ycb.MODEL_DENSITIES.get(m, 1000.0) for m in self.model_ids], np.float64)
        self._pending_mass = np.clip(0.4 * vol * dens, 0.02, 2.0)

        self.goal_site = actors.build_sphere(
            self.scene,
            radius=self.goal_thresh,
            color=[0, 1, 0, 1],
            name="goal_site",
            body_type="kinematic",
            add_collision=False,
            initial_pose=np.array([0, 0, 0, 1, 0, 0, 0]),
        )
        self._hidden_objects.append(self.goal_site)
        # the arm starts higher above the table than in the other tabletop tasks
        self._arm_qpos = torch.tensor(
            [0.0, 0, 0, -np.pi * 2 / 3, 0, np.pi * 2 / 3, np.pi / 4, 0.04, 0.04], device=self.device)

    def _after_reconfigure(self, options: dict):
        self.scene.set_per_env_hulls(self.obj, self._pending_hulls)
        self.scene.set_per_env_body_mass(self.obj, self._pending_mass)

    def _initialize_episode(self, env_idx: torch.Tensor, options: dict):
        self.table_scene.initialize(env_idx)
        rng = self._batched_episode_rng
        xy = rng.uniform(-0.1, 0.1, (2,))
        xyz = torch.cat([xy, self.object_zs[:, None]], -1)
        self.obj.set_pose(Pose(torch.cat([xyz, rng.quaternions(lock_x=True, lock_y=True)], -1)))

        gxy = rng.uniform(-0.1, 0.1, (2,))
        gz = rng.uniform(0.0, 0.3) + xyz[:, 2]
        goal = torch.cat([gxy, gz[:, None]], -1)
        ident = torch.zeros(self.num_envs, 4, device=self.device)
        ident[:, 0] = 1.0
        self.goal_site.set_pose(Pose(torch.cat([goal, ident], -1)))

        noise = rng.normal(0.0, self.robot_init_qpos_noise, (7,))
        qpos = self._arm_qpos.expand(self.num_envs, 9).clone()
        qpos[:, :7] += noise
        self.agent.reset(qpos)

    def _get_obs_extra(self, info: dict):
        obs = dict(
            is_grasped=info["is_grasped"],
            tcp_pose=self.agent.tcp_pose.raw_pose,
            goal_pos=self.goal_site.pose.p,
        )
        if "state" in self.obs_mode:
            obs.update(
                tcp_to_goal_pos=self.goal_site.pose.p - self.agent.tcp_pose.p,
                obj_pose=self.obj.pose.raw_pose,
                tcp_to_obj_pos=self.obj.pose.p - self.agent.tcp_pose.p,
                obj_to_goal_pos=self.goal_site.pose.p - self.obj.pose.p,
            )
        return obs

    def evaluate(self):
        obj_to_goal = self.goal_site.pose.p - self.obj.pose.p
        is_obj_placed = torch.linalg.vector_norm(obj_to_goal, dim=1) <= self.goal_thresh
        is_robot_static = self.agent.is_static(0.2)
        return {
            "success": is_obj_placed & is_robot_static,
            "is_obj_placed": is_obj_placed,
            "is_robot_static": is_robot_static,
            "is_grasped": self.agent.is_grasping(self.obj),
        }

    def compute_dense_reward(self, obs, action, info):
        tcp_to_obj_dist = torch.linalg.vector_norm(self.obj.pose.p - self.agent.tcp_pose.p, dim=1)
        reward = 1 - torch.tanh(5 * tcp_to_obj_dist)

        is_grasped = info["is_grasped"].to(torch.float32)
        reward = reward + is_grasped

        obj_to_goal_dist = torch.linalg.vector_norm(self.goal_site.pose.p - self.obj.pose.p, dim=1)
        reward = reward + (1 - torch.tanh(5 * obj_to_goal_dist)) * is_grasped

        qvel = self.agent.robot.qvel[..., :-2]
        static_reward = 1 - torch.tanh(5 * torch.linalg.vector_norm(qvel, dim=1))
        reward = reward + static_reward * info["is_obj_placed"].to(torch.float32)
        return torch.where(info["success"], 6.0, reward)

    def compute_normalized_dense_reward(self, obs, action, info):
        return self.compute_dense_reward(obs=obs, action=action, info=info) / 6
