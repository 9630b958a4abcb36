"""RotateSingleObjectInHandLevel{0-3}-v1 (counterpart of
maniskill_tpu/envs/tasks/dexterity/rotate_single_object_in_hand.py): an
Allegro hand held palm up must spin an object about an axis to a cumulative
4 pi.

Levels: 0 a fixed-size cube about z; 1 a cube whose size each env draws
from ``np.random.RandomState(2024)`` (its collision and visual boxes through
``set_per_env_geom_sizes``), about z; 2 the same cube sizes about a random
axis; 3 a different YCB stand-in per env (cooked to 4 hulls, normalised to
7 cm, through ``set_per_env_hulls``) about a random axis.

The rotation axis, the tracked tangent and the cumulative angle are extras
of the sim state. ``evaluate`` advances the last two in every env (not
masked), and reset calls it too, so it must run exactly as often as the JAX
package runs it: once per reset and once per step.
"""
from __future__ import annotations

import numpy as np
import torch

from ....building import actors
from ....building.ground import build_ground
from ....sensors.camera import CameraConfig
from ....structs.pose import Pose
from ....structs.types import SceneConfig, SimConfig
from ....utils.geometry import rotation_conversions as rc
from ....utils.registration import register_env
from ....utils.scene_utils import look_at
from ...base_env import BaseEnv
from ...utils.observations import parse_obs_mode_to_struct

_HAND_INIT_HEIGHT = 0.25
_SUCCESS_ANGLE = 4 * np.pi


class RotateSingleObjectInHand(BaseEnv):
    SUPPORTED_ROBOTS = ["allegro_hand_right_touch"]
    difficulty_level: int = 0

    def __init__(self, *args, robot_uids="allegro_hand_right_touch", **kwargs):
        self.base_half_size = 0.035
        super().__init__(*args, robot_uids=robot_uids, **kwargs)

    @property
    def _default_sim_config(self):
        return SimConfig(sim_freq=120, control_freq=60, scene_config=SceneConfig(solver_position_iterations=16))

    @property
    def _default_sensor_configs(self):
        pose = look_at(eye=[0.3, 0.3, 0.5], target=[0, 0, 0.25])
        return [CameraConfig("base_camera", pose, 128, 128, np.pi / 2, 0.01, 100)]

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at([0.25, 0.25, 0.4], [0, 0, 0.25])
        return CameraConfig("render_camera", pose, 512, 512, 1, 0.01, 100)

    def _load_agent(self, options: dict):
        # palm up at a fixed height
        super()._load_agent(options, np.array([0, 0, _HAND_INIT_HEIGHT, -0.7071068, 0, 0.7071068, 0]))

    def _register_extras(self):
        self.scene.register_extra("rot_dir", (3,))
        self.scene.register_extra("prev_unit_vector", (3,))
        self.scene.register_extra("cum_rotation_angle", ())

    def _load_scene(self, options: dict):
        self.ground = build_ground(self.scene)
        self.obj = actors.build_cube(
            self.scene, half_size=self.base_half_size, color=[1, 0.3, 0, 1], name="obj",
            initial_pose=np.array([0, 0, _HAND_INIT_HEIGHT + 0.06, 1, 0, 0, 0]),
        )
        self._register_extras()

    def _set_object_geometry(self) -> np.ndarray:
        """Write the object's per-env geometry into the model; returns the
        (B,) float32 heights its reset height adds."""
        if self.difficulty_level >= 1:
            sizes = np.random.RandomState(2024).uniform(0.03, 0.042, (self.num_envs,)).astype(np.float32)
            gids = self.obj.geom_ids
            hs = np.repeat(np.repeat(sizes[:, None, None], len(gids), 1), 3, 2)
            self.scene.set_per_env_geom_sizes_by_id(gids, hs)
            return sizes
        return np.full((self.num_envs,), self.base_half_size, np.float32)

    def _after_reconfigure(self, options: dict):
        dev = self.device
        self._obj_heights = torch.as_tensor(self._set_object_geometry(), device=dev)
        self._identity_q = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)

    def _initialize_episode(self, env_idx, options: dict):
        b = self.num_envs
        rng = self._batched_episode_rng
        xy = 0.02 * (2 * rng.uniform(0.0, 1.0, (2,)) - 1)
        z = _HAND_INIT_HEIGHT + self._obj_heights + 0.03
        self.obj.set_pose(Pose.create_from_pq(torch.cat([xy, z[:, None]], -1), self._identity_q))
        self.agent.reset(0.2 * rng.uniform(0.0, 1.0, (16,)))

        if self.difficulty_level >= 2:
            axis = (rng.uniform(0.0, 1.0) * 3).to(torch.int32) % 3
        else:
            axis = torch.full((b,), 2, dtype=torch.int32, device=self.device)
        rot_dir = torch.nn.functional.one_hot(axis.long(), 3).to(torch.float32)
        tangent = torch.nn.functional.one_hot(((axis + 1) % 3).long(), 3).to(torch.float32)
        self.scene.set_extra("rot_dir", rot_dir)
        self.scene.set_extra("prev_unit_vector", tangent)
        self.scene.set_extra("cum_rotation_angle", torch.zeros(b, device=self.device))

    def evaluate(self):
        obj_pose = self.obj.pose
        rot_dir = self.scene.get_extra("rot_dir")
        prev = self.scene.get_extra("prev_unit_vector")
        # a body-fixed tangent projected onto the rotation plane; the angle
        # it turned since the last call (arccos of a dot clipped to [0, 1]:
        # never negative, ~3e-4 rad in f32 when nothing moved)
        tangent0 = torch.roll(rot_dir, 1, -1)
        v = rc.quaternion_apply(obj_pose.q, tangent0)
        v = v - torch.sum(v * rot_dir, -1, keepdim=True) * rot_dir
        v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-8)
        angle = torch.arccos(torch.clamp(torch.sum(v * prev, -1), 0.0, 1.0))
        angle = torch.clamp(angle, -np.pi / 20, np.pi / 20)
        self.scene.set_extra("prev_unit_vector", v, masked=False)
        cum = self.scene.get_extra("cum_rotation_angle") + angle
        self.scene.set_extra("cum_rotation_angle", cum, masked=False)

        obj_vel = torch.linalg.vector_norm(self.obj.linear_velocity, dim=-1)
        obj_fall = obj_pose.p[:, 2] < (_HAND_INIT_HEIGHT - 0.05)
        tip_p = self.agent.tip_poses[..., :3]  # (B, 4, 3)
        obj_tip_dist = torch.linalg.vector_norm(tip_p - obj_pose.p[:, None, :], dim=-1)
        return dict(rotation_angle=angle, obj_vel=obj_vel, obj_fall=obj_fall, obj_tip_dist=obj_tip_dist,
                    success=cum > _SUCCESS_ANGLE, fail=obj_fall)

    def _get_obs_extra(self, info: dict):
        obs = dict(rotate_dir=self.scene.get_extra("rot_dir"))
        if parse_obs_mode_to_struct(self.obs_mode)["use_state"]:
            obs.update(
                obj_pose=self.obj.pose.raw_pose,
                palm_pose=self.agent.palm_pose,
                tip_poses=self.agent.tip_poses.reshape(self.num_envs, -1),
                cum_rotation=self.scene.get_extra("cum_rotation_angle")[:, None],
            )
        return obs

    def compute_dense_reward(self, obs, action, info: dict):
        reward = 20.0 * info["rotation_angle"]
        reward = reward - 0.1 * info["obj_vel"]
        reward = reward - 50.0 * info["obj_fall"].to(torch.float32)
        dist_rew = torch.clamp(0.1 / (0.02 + 4 * info["obj_tip_dist"]), 0, 1)
        return reward + torch.mean(dist_rew, -1)

    def compute_normalized_dense_reward(self, obs, action, info):
        return self.compute_dense_reward(obs, action, info) / 4.0


@register_env("RotateSingleObjectInHandLevel0-v1", max_episode_steps=300)
class RotateSingleObjectInHandLevel0(RotateSingleObjectInHand):
    difficulty_level = 0


@register_env("RotateSingleObjectInHandLevel1-v1", max_episode_steps=300)
class RotateSingleObjectInHandLevel1(RotateSingleObjectInHand):
    difficulty_level = 1


@register_env("RotateSingleObjectInHandLevel2-v1", max_episode_steps=300)
class RotateSingleObjectInHandLevel2(RotateSingleObjectInHand):
    difficulty_level = 2


@register_env("RotateSingleObjectInHandLevel3-v1", max_episode_steps=300)
class RotateSingleObjectInHandLevel3(RotateSingleObjectInHand):
    """A YCB stand-in per env, each drawn from the main RNG (or
    ``RandomState(2024)`` at the first build), cooked to 4 hulls and
    scaled so its longest edge is 7 cm, about a random axis."""

    difficulty_level = 3
    _YCB_MAX_HULLS = 4

    def _load_scene(self, options: dict):
        from ....building.actors import ycb
        from ....building.cooking import HULL_MAX_VERTS

        self.ground = build_ground(self.scene)
        rng = self._main_rng or np.random.RandomState(2024)
        model_ids = rng.choice(np.array(ycb.all_model_ids()), size=self.num_envs, replace=True)
        self.model_ids = model_ids

        cooked = {}
        for mid in np.unique(model_ids):
            parts = ycb.cooked_hulls(mid, max_parts=self._YCB_MAX_HULLS)
            while len(parts) < self._YCB_MAX_HULLS:
                parts.append(parts[0])
            cooked[mid] = np.stack(parts[: self._YCB_MAX_HULLS])

        # each model scaled so its longest AABB edge is 7 cm, centred
        hulls = np.stack([cooked[m] for m in model_ids])  # (B, K, V, 3)
        lo = hulls.reshape(self.num_envs, -1, 3).min(axis=1)
        hi = hulls.reshape(self.num_envs, -1, 3).max(axis=1)
        longest = np.maximum((hi - lo).max(axis=1), 1e-4)
        scale = (0.07 / longest)[:, None, None, None].astype(np.float32)
        center = (0.5 * (lo + hi))[:, None, None, :].astype(np.float32)
        hulls = (hulls - center) * scale
        assert hulls.shape[2] == HULL_MAX_VERTS

        builder = self.scene.create_actor_builder()
        for k in range(self._YCB_MAX_HULLS):
            builder.add_convex_collision_from_mesh(hulls[0, k], density=1000.0, color=[1, 0.3, 0, 1])
        builder.set_initial_pose(np.array([0, 0, _HAND_INIT_HEIGHT + 0.06, 1, 0, 0, 0]))
        self.obj = builder.build(name="obj")
        self._pending_hulls = hulls
        self._register_extras()

    def _set_object_geometry(self) -> np.ndarray:
        self.scene.set_per_env_hulls(self.obj, self._pending_hulls)
        # the highest scaled vertex: the resting clearance above the palm
        return self._pending_hulls.reshape(self.num_envs, -1, 3)[:, :, 2].max(axis=1).astype(np.float32)
