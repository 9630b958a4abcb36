"""RoboCasa kitchens (counterpart of
maniskill_tpu/envs/tasks/mobile_manipulation/robocasa_kitchen.py).

RoboCasaKitchen-v1 is a whole kitchen (counters, sink, stove with an oven
door, fridge, dishwasher, cabinets and drawers with articulated doors;
``scene_builder/robocasa/``) with a mobile manipulator and loose kitchen
objects spawned on the counters each episode. Like the reference it is a
platform: ``evaluate`` returns no success and the reward mode is "none".
RoboCasaOpenDrawer-v1 and RoboCasaPnPCounterToSink-v1 are its two concrete
tasks.

The layout is chosen by ``build_config_idxs`` (or ``layout_ids``) at
reconfigure; object poses are drawn anew every episode. Two faults of the
reference are repaired here: the platform sets ``articulated`` beside
``articulated_fixtures`` (OpenDrawer reads the first), and PnPCounterToSink
builds its sink tables on the host from the layout when the scene loads
(the reference writes them inside the traced reset).
"""
from __future__ import annotations

import numpy as np
import torch

from ....scene_builder.robocasa import fixtures as F
from ....scene_builder.robocasa.scene_builder import RoboCasaSceneBuilder
from ....sensors.camera import CameraConfig
from ....structs.pose import Pose
from ....structs.types import SimConfig
from ....utils.registration import register_env
from ....utils.scene_utils import look_at
from ...base_env import BaseEnv

# procedural stand-ins for the sampled kitchen objects: (name, shape,
# params, color)
KITCHEN_OBJECTS = [
    ("can", "cylinder", (0.033, 0.06), (0.85, 0.25, 0.2, 1)),
    ("box", "box", (0.04, 0.03, 0.06), (0.9, 0.75, 0.3, 1)),
    ("apple", "sphere", (0.038,), (0.8, 0.15, 0.1, 1)),
    ("lemon", "sphere", (0.03,), (0.95, 0.85, 0.2, 1)),
    ("mug", "cylinder", (0.04, 0.045), (0.3, 0.5, 0.8, 1)),
    ("bowl", "cylinder", (0.07, 0.03), (0.9, 0.9, 0.9, 1)),
]


@register_env("RoboCasaKitchen-v1", max_episode_steps=100)
class RoboCasaKitchenEnv(BaseEnv):
    SUPPORTED_ROBOTS = ["fetch", "none", "unitree_g1_simplified_upper_body"]
    SUPPORTED_REWARD_MODES = ("none",)

    def __init__(self, *args, robot_uids="fetch", layout_ids=None, fixtures_only=False, num_objects=4, **kwargs):
        self.layout_ids = layout_ids
        self.fixtures_only = fixtures_only
        self.num_objects = 0 if fixtures_only else num_objects
        kwargs.setdefault("reward_mode", "none")
        super().__init__(*args, robot_uids=robot_uids, **kwargs)

    @property
    def _default_sim_config(self):
        return SimConfig(sim_freq=100, control_freq=20)

    @property
    def _default_sensor_configs(self):
        pose = look_at(eye=[0.7, 0.0, 1.5], target=[-1.0, 0.0, 0.8])
        return [CameraConfig("base_camera", pose, 128, 128, np.pi / 2, 0.01, 100)]

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at([2.2, 2.2, 2.0], [-0.6, -0.4, 0.8])
        return CameraConfig("render_camera", pose, 512, 512, 1, 0.01, 100)

    def _load_agent(self, options: dict):
        super()._load_agent(options, np.array([0.4, 0.3, 0, 1, 0, 0, 0]))

    def _load_scene(self, options: dict):
        self.scene_builder = RoboCasaSceneBuilder(self)
        idxs = options.get("build_config_idxs")
        if idxs is None and self.layout_ids is not None:
            idxs = [self.layout_ids] if isinstance(self.layout_ids, int) else list(self.layout_ids)
        self.scene_builder.build(idxs)
        self.fixtures = self.scene_builder.fixtures
        # both names: the tasks read ``articulated`` (the reference sets only
        # the first and its OpenDrawer cannot be made)
        self.articulated_fixtures = self.articulated = self.scene_builder.articulated

        self.objects = []
        for i in range(self.num_objects):
            name, shape, params, color = KITCHEN_OBJECTS[i % len(KITCHEN_OBJECTS)]
            b = self.scene.create_actor_builder()
            if shape == "cylinder":
                b.add_cylinder_collision(radius=params[0], half_length=params[1], friction=0.8, density=400)
                b.add_cylinder_visual(radius=params[0], half_length=params[1], color=color)
            elif shape == "sphere":
                b.add_sphere_collision(radius=params[0], friction=0.8, density=500)
                b.add_sphere_visual(radius=params[0], color=color)
            else:
                b.add_box_collision(half_size=list(params), friction=0.8, density=400)
                b.add_box_visual(half_size=list(params), color=color)
            b.set_initial_pose(np.array([0.0, 0.0, 1.2 + 0.1 * i, 1, 0, 0, 0]))
            self.objects.append(b.build(f"{name}_{i}"))
        self._rest_qpos = None
        if getattr(self.agent, "robot", None) is not None:
            kf = self.agent.keyframes.get("rest") or next(iter(self.agent.keyframes.values()), None)
            if kf is not None:
                self._rest_qpos = torch.as_tensor(np.asarray(kf.qpos, np.float32).reshape(-1), device=self.device)

    def _initialize_episode(self, env_idx: torch.Tensor, options: dict):
        rng = self._batched_episode_rng
        self.scene_builder.initialize(env_idx)
        if self._rest_qpos is not None:
            self.agent.reset(self._rest_qpos.expand(self.num_envs, int(self.agent.robot.dof)))
        for i, obj in enumerate(self.objects):
            # clearance over the counter for each object's own extent
            pos = self.scene_builder.counter_spawn_pose(rng)
            pos[:, 2] += 0.06 + 0.01 * i
            q = rng.quaternions(lock_x=True, lock_y=True)
            obj.set_pose(Pose.create_from_pq(pos, q))

    def evaluate(self):
        # a platform: its tasks define success
        return {}

    def _get_obs_extra(self, info: dict):
        return {}


@register_env("RoboCasaOpenDrawer-v1", max_episode_steps=100)
class RoboCasaOpenDrawerEnv(RoboCasaKitchenEnv):
    """Open the drawer stack's top drawer past ``OPEN_MIN`` metres."""

    SUPPORTED_REWARD_MODES = ("none", "sparse", "dense", "normalized_dense")
    OPEN_MIN = 0.15  # metres along the 0.4 m prismatic travel

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("fixtures_only", True)
        kwargs.setdefault("reward_mode", "dense")
        super().__init__(*args, **kwargs)

    def _load_scene(self, options: dict):
        super()._load_scene(options)
        stack = next((v for k, v in sorted(self.articulated.items()) if k.startswith("drawer_stack")), None)
        if stack is None:  # a layout without a drawer stack
            stack = next(iter(sorted(self.articulated.items())))[1]
        self.drawer_stack = stack
        # the top drawer: the highest origin, the last drawer_* joint
        drawer_joints = [j for j in stack.active_joints if "drawer" in (j.name or "")]
        self.target_joint = (drawer_joints or stack.active_joints)[-1]
        self.target_link = self.target_joint.child_link

    def evaluate(self):
        open_amount = self.target_joint.qpos[:, 0]
        return dict(success=open_amount >= self.OPEN_MIN, open_amount=open_amount)

    def _get_obs_extra(self, info: dict):
        obs = dict(open_amount=info["open_amount"][:, None])
        if "state" in self.obs_mode:
            obs["drawer_pos"] = self.target_link.pose.p
            obs["tcp_pose"] = self.agent.tcp.pose.raw_pose
        return obs

    def compute_dense_reward(self, obs, action, info):
        tcp = self.agent.tcp.pose.p
        # the link origin is the bin's centre, the handle on its front
        handle = self.target_link.pose.p
        reach = 1.0 - torch.tanh(5.0 * torch.linalg.vector_norm(handle - tcp, dim=-1))
        open_frac = torch.clamp(info["open_amount"] / self.OPEN_MIN, 0.0, 1.0)
        reward = reach + 4.0 * open_frac
        return torch.where(info["success"], reward + 2.0, reward)

    def compute_normalized_dense_reward(self, obs, action, info):
        return self.compute_dense_reward(obs, action, info) / 7.0


@register_env("RoboCasaPnPCounterToSink-v1", max_episode_steps=200)
class RoboCasaPnPCounterToSinkEnv(RoboCasaKitchenEnv):
    """Pick the target object off a counter and place it in the sink basin:
    success is the object inside the basin and near static."""

    SUPPORTED_REWARD_MODES = ("none", "sparse", "dense", "normalized_dense")

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("num_objects", 3)  # 1 target + 2 distractors
        kwargs.setdefault("reward_mode", "dense")
        super().__init__(*args, **kwargs)

    def _load_scene(self, options: dict):
        super()._load_scene(options)
        self.target_object = self.objects[0]
        # the basin's frame, from the layout on the host (the reference
        # writes these inside its traced reset and leaks a tracer)
        sb = self.scene_builder
        if "sink_basin" in sb.regions:
            center, yaw, half, _ = sb.regions["sink_basin"]
        else:  # a layout without a sink: the first counter slot
            center, yaw, _ = sb.counter_slots[0]
            half = np.array([0.16, 0.24], np.float32)
        center = np.asarray(center, np.float32)
        self._sink_yaw = float(yaw)
        dev = self.device
        self._sink_center = torch.as_tensor(center, device=dev)
        self._sink_half = torch.as_tensor(np.asarray(half, np.float32), device=dev)
        self._sink_center3 = torch.as_tensor(np.append(center, 0.0).astype(np.float32), device=dev)
        self._sink_target = torch.as_tensor(np.append(center, F.COUNTER_H - 0.08).astype(np.float32), device=dev)

    def evaluate(self):
        p = self.target_object.pose.p
        rel = p[:, :2] - self._sink_center
        cos, sin = float(np.cos(self._sink_yaw)), float(np.sin(self._sink_yaw))  # host floats of the layout
        local = torch.stack([cos * rel[:, 0] + sin * rel[:, 1], -sin * rel[:, 0] + cos * rel[:, 1]], -1)
        in_basin_xy = torch.all(torch.abs(local) <= self._sink_half, -1)
        in_basin_z = p[:, 2] < F.COUNTER_H - 0.02  # below the counter's rim
        speed = torch.linalg.vector_norm(self.target_object.linear_velocity, dim=-1)
        return dict(
            success=in_basin_xy & in_basin_z & (speed < 0.15),
            in_basin=in_basin_xy & in_basin_z,
            is_grasped=self.agent.is_grasping(self.target_object),
        )

    def _get_obs_extra(self, info: dict):
        obs = dict(is_grasped=info["is_grasped"][:, None])
        if "state" in self.obs_mode:
            obs["obj_pose"] = self.target_object.pose.raw_pose
            obs["tcp_pose"] = self.agent.tcp.pose.raw_pose
            obs["sink_center"] = self._sink_center3.expand(self.num_envs, 3)
        return obs

    def compute_dense_reward(self, obs, action, info):
        tcp = self.agent.tcp.pose.p
        obj = self.target_object.pose.p
        reach = 1.0 - torch.tanh(5.0 * torch.linalg.vector_norm(obj - tcp, dim=-1))
        grasped = info["is_grasped"].to(torch.float32)
        place = 1.0 - torch.tanh(3.0 * torch.linalg.vector_norm(obj - self._sink_target, dim=-1))
        reward = reach + grasped + 2.0 * place * grasped
        reward = torch.where(info["in_basin"], reward + 1.0, reward)
        return torch.where(info["success"], reward + 2.0, reward)

    def compute_normalized_dense_reward(self, obs, action, info):
        return self.compute_dense_reward(obs, action, info) / 7.0
