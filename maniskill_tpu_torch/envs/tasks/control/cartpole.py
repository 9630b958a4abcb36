"""CartPole balance/swing-up (counterpart of
maniskill_tpu/envs/tasks/control/cartpole.py, dm_control suite semantics).

The cartpole robot is defined procedurally from the dm_control cartpole.xml
parameters (cart 1 kg box + 0.1 kg capsule pole, slide range ±1.8 m).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ....agents.base_agent import BaseAgent
from ....agents.controllers import PassiveControllerConfig, PDJointPosControllerConfig
from ....building.articulation_builder import ArticulationBuilder, LinkSpec, ShapeSpec
from ....physics.types import BOX, CAPSULE, HINGE, SLIDE
from ....sensors.camera import CameraConfig
from ....structs.types import SceneConfig, SimConfig
from ....utils.registration import register_env
from ....utils.scene_utils import look_at
from ...base_env import BaseEnv
from ...utils import rewards


class CartPoleRobot(BaseAgent):
    uid = "cart_pole"
    disable_self_collisions = True

    def build_description(self):
        b = ArticulationBuilder(self.scene)
        # root "rail" fixed to world; cart slides along x at z=1
        b.add_link(LinkSpec("rail", None))
        b.add_link(
            LinkSpec(
                "cart", "rail", SLIDE, "slider",
                origin_pos=(0, 0, 1.0), axis=(1, 0, 0), limit=(-1.8, 1.8),
                damping=5e-4,
                mass=1.0, inertia=np.array([0.0108, 0.0167, 0.0208]),
                collisions=[], visuals=[ShapeSpec(BOX, (0.2, 0.15, 0.1), color=(0.8, 0.2, 0.2, 1))],
            )
        )
        b.add_link(
            LinkSpec(
                "pole_1", "cart", HINGE, "hinge_1",
                axis=(0, 1, 0), damping=2e-6,
                mass=0.1, com=(0, 0, 0.5), inertia=np.array([0.00845, 0.00845, 1.01e-4]),
                collisions=[],
                visuals=[ShapeSpec(CAPSULE, (0.045, 0.5, 0), pos=(0, 0, 0.5), color=(0.2, 0.4, 0.8, 1))],
            )
        )
        return b

    @property
    def _controller_configs(self):
        pd_joint_delta_pos = PDJointPosControllerConfig(
            joint_names=["slider"], lower=-1, upper=1,
            damping=200, stiffness=2000, use_delta=True,
        )
        rest = PassiveControllerConfig(joint_names=["hinge_1"], damping=0, friction=0)
        return dict(
            pd_joint_delta_pos=dict(slider=pd_joint_delta_pos, rest=rest, balance_passive_force=False)
        )


class CartpoleEnv(BaseEnv):
    agent: CartPoleRobot

    def __init__(self, *args, robot_uids=CartPoleRobot, **kwargs):
        super().__init__(*args, robot_uids=robot_uids, **kwargs)

    @property
    def _default_sim_config(self):
        return SimConfig(scene_config=SceneConfig(solver_position_iterations=4))

    @property
    def _default_sensor_configs(self):
        pose = look_at(eye=[0, -4, 1], target=[0, 0, 1])
        return [CameraConfig("base_camera", pose, 128, 128, np.pi / 2, 0.01, 100)]

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at(eye=[0, -4, 1], target=[0, 0, 1])
        return CameraConfig("render_camera", pose, 512, 512, 1, 0.01, 100)

    def _load_scene(self, options: dict):
        # background wall (visual only)
        wall = self.scene.create_actor_builder()
        wall.add_box_visual(half_size=(1e-3, 20, 10), color=(0.3, 0.3, 0.3, 1))
        wall.set_initial_pose(np.array([1, 0, 1, 0.7071068, 0, 0, 0.7071068]))
        wall.build_static(name="wall")

    def evaluate(self):
        return dict()

    def _get_obs_extra(self, info: dict):
        pole = self.agent.robot.links_map["pole_1"]
        return dict(velocity=pole.linear_velocity, angular_velocity=pole.angular_velocity)

    @property
    def pole_angle_cosine(self):
        return torch.cos(self.agent.robot.joints_map["hinge_1"].qpos[:, 0])

    def compute_dense_reward(self, obs, action, info):
        cart_pos = self.agent.robot.links_map["cart"].pose.p[:, 0]
        centered = (1 + rewards.tolerance(cart_pos, margin=2)) / 2
        small_control = rewards.tolerance(
            action, margin=1, value_at_margin=0, sigmoid="quadratic"
        )[:, 0]
        small_control = (4 + small_control) / 5
        angular_vel = self.agent.robot.qvel[:, 1]
        small_velocity = (1 + rewards.tolerance(angular_vel, margin=5)) / 2
        upright = (self.pole_angle_cosine + 1) / 2
        return upright * centered * small_control * small_velocity

    def compute_normalized_dense_reward(self, obs, action, info):
        return self.compute_dense_reward(obs=obs, action=action, info=info)


@register_env("MS-CartpoleBalance-v1", max_episode_steps=1000)
class CartpoleBalanceEnv(CartpoleEnv):
    def _initialize_episode(self, env_idx, options: dict):
        rng = self._batched_episode_rng
        q0 = rng.uniform(-0.1, 0.1)
        q1 = rng.uniform(-0.034, 0.034)
        self.agent.robot.set_qpos(torch.stack([q0, q1], -1))
        self.agent.robot.set_qvel(rng.normal(0.0, 0.01, size=(2,)))
        self.agent.controller.reset()

    def evaluate(self):
        return dict(fail=self.pole_angle_cosine < 0)


@register_env("MS-CartPole-v1", max_episode_steps=500)
class LegacyCartPoleEnv(CartpoleBalanceEnv):
    pass


@register_env("MS-CartpoleSwingUp-v1", max_episode_steps=1000)
class CartpoleSwingUpEnv(CartpoleEnv):
    def _initialize_episode(self, env_idx, options: dict):
        rng = self._batched_episode_rng
        q0 = rng.normal(0.0, 0.01)
        q1 = rng.uniform(-math.pi, math.pi)
        self.agent.robot.set_qpos(torch.stack([q0, q1], -1))
        self.agent.robot.set_qvel(rng.normal(0.0, 0.01, size=(2,)))
        self.agent.controller.reset()
