"""Ant quadruped control tasks (counterpart of
maniskill_tpu/envs/tasks/control/ant.py: MS-AntWalk-v1 / MS-AntRun-v1).

The ant is defined procedurally from the classic MuJoCo ant.xml constants
(torso sphere and 4 capsules, 4 legs of hip and ankle hinges, density 5) on a
free root.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ....agents.base_agent import BaseAgent, Keyframe
from ....agents.controllers import PDJointPosControllerConfig
from ....building.articulation_builder import ArticulationBuilder, LinkSpec, ShapeSpec
from ....building.ground import build_ground
from ....physics.types import HINGE, SPHERE
from ....sensors.camera import CameraConfig
from ....structs.types import SceneConfig, SimConfig
from ....utils.registration import register_env
from ....utils.scene_utils import look_at
from ...base_env import BaseEnv
from ...utils import rewards
from .hopper import _fromto_capsule, link_mass_table

_STAND_HEIGHT = 0.55
_WALK_SPEED = 0.5
_RUN_SPEED = 4.0


def _cap(a, b, r):
    s = _fromto_capsule(a, b, r, friction=1.5)
    s.density = 5.0
    return s


class AntRobot(BaseAgent):
    uid = "ant"
    fix_root_link = False
    disable_self_collisions = True

    # qpos in the builder's (interleaved hip_i, ankle_i) order
    keyframes = dict(
        stand=Keyframe(
            qpos=np.array([0, 1.0, 0, -1.0, 0, -1.0, 0, 1.0]),
            pose=np.array([0, 0, 0.55, 0.7071068, 0, 0, 0.7071068]),
        )
    )

    def build_description(self):
        b = ArticulationBuilder(self.scene)
        deg = np.deg2rad
        torso_shapes = [
            ShapeSpec(SPHERE, [0.25, 0, 0], density=5.0, friction=1.5),
            _cap((0, 0, 0), (0.2, 0.2, 0), 0.08),
            _cap((0, 0, 0), (-0.2, 0.2, 0), 0.08),
            _cap((0, 0, 0), (-0.2, -0.2, 0), 0.08),
            _cap((0, 0, 0), (0.2, -0.2, 0), 0.08),
        ]
        b.add_link(LinkSpec("torso", None, collisions=torso_shapes, visuals=torso_shapes))
        legs = [
            # (name, hip_pos, leg_dir, hip_range, ankle_axis, ankle_range)
            ("front_left", (0.2, 0.2, 0), (0.2, 0.2, 0), (-40, 40), (-1, 1, 0), (30, 100)),
            ("front_right", (-0.2, 0.2, 0), (-0.2, 0.2, 0), (-40, 40), (1, 1, 0), (-100, -30)),
            ("left_back", (-0.2, -0.2, 0), (-0.2, -0.2, 0), (-40, 40), (-1, 1, 0), (-100, -30)),
            ("right_back", (0.2, -0.2, 0), (0.2, -0.2, 0), (-40, 40), (1, 1, 0), (30, 100)),
        ]
        for i, (name, hip_pos, d, hr, aaxis, ar) in enumerate(legs, 1):
            leg_shape = [_cap((0, 0, 0), d, 0.08)]
            b.add_link(LinkSpec(
                f"{name}_leg", "torso", HINGE, f"hip_{i}", origin_pos=hip_pos, axis=(0, 0, 1),
                limit=(deg(hr[0]), deg(hr[1])), damping=0.1, armature=0.01,
                collisions=leg_shape, visuals=leg_shape,
            ))
            foot_shape = [_cap((0, 0, 0), (2 * d[0], 2 * d[1], 0), 0.08)]
            b.add_link(LinkSpec(
                f"{name}_foot", f"{name}_leg", HINGE, f"ankle_{i}", origin_pos=d, axis=aaxis,
                limit=(deg(ar[0]), deg(ar[1])), damping=0.1, armature=0.01,
                collisions=foot_shape, visuals=foot_shape,
            ))
        return b

    @property
    def _controller_configs(self):
        body = PDJointPosControllerConfig(
            joint_names=[f"hip_{i}" for i in range(1, 5)] + [f"ankle_{i}" for i in range(1, 5)],
            lower=-1, upper=1, damping=1e2, stiffness=1e3, use_delta=True,
        )
        return dict(pd_joint_delta_pos=dict(body=body, balance_passive_force=False))


class AntEnv(BaseEnv):
    agent: AntRobot

    def __init__(self, *args, robot_uids=AntRobot, move_speed=0.0, **kwargs):
        self.move_speed = move_speed
        super().__init__(*args, robot_uids=robot_uids, **kwargs)

    @property
    def _default_sim_config(self):
        return SimConfig(sim_freq=100, control_freq=50,
                         scene_config=SceneConfig(solver_position_iterations=12))

    @property
    def _default_sensor_configs(self):
        pose = look_at(eye=[0, -3, 1.5], target=[0, 0, 0.3])
        return [CameraConfig("base_camera", pose, 128, 128, np.pi / 2, 0.01, 100)]

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at([0, -4, 2], [0, 0, 0.3])
        return CameraConfig("render_camera", pose, 512, 512, 1, 0.01, 100)

    def _load_scene(self, options: dict):
        self.ground = build_ground(self.scene, friction=1.5)

    def _after_reconfigure(self, options: dict):
        self._link_ids, self._link_masses, self._robot_mass = link_mass_table(self, self.agent.robot.links)
        kf = self.agent.keyframes["stand"]
        self._stand_pose = torch.as_tensor(kf.pose, dtype=torch.float32, device=self.device)
        self._stand_qpos = torch.as_tensor(kf.qpos, dtype=torch.float32, device=self.device)

    def _initialize_episode(self, env_idx, options: dict):
        rng = self._batched_episode_rng
        robot = self.agent.robot
        robot.set_root_pose(self._stand_pose)
        robot.set_qpos(self._stand_qpos + rng.uniform(-0.01, 0.01, (8,)))
        robot.set_qvel(rng.uniform(-0.01, 0.01, (8,)))
        self.agent.controller.reset()

    @property
    def torso_height(self):
        return self.agent.robot.links_map["torso"].pose.p[:, 2]

    @property
    def com_velx(self):
        vels = self.scene.data.cvel[:, self._link_ids, 0]  # (B, links)
        return torch.sum(vels * self._link_masses, 1) / self._robot_mass

    def evaluate(self):
        return {}

    def _get_obs_extra(self, info: dict):
        return dict(
            height=self.torso_height,
            root_quat=self.agent.robot.root_pose.q,
            com_velx=self.com_velx,
        )

    def standing_rew(self):
        return rewards.tolerance(self.torso_height, lower=_STAND_HEIGHT, upper=math.inf,
                                 margin=_STAND_HEIGHT / 4)

    def small_control_rew(self, action):
        ctrl = rewards.tolerance(action, margin=1, value_at_margin=0, sigmoid="quadratic").mean(-1)
        return (4 + ctrl) / 5

    def move_x_rew(self, move_speed=_WALK_SPEED):
        return rewards.tolerance(self.com_velx, lower=move_speed, upper=math.inf,
                                 margin=move_speed, value_at_margin=0, sigmoid="linear")

    def compute_dense_reward(self, obs, action, info):
        return self.small_control_rew(action) * self.move_x_rew(self.move_speed) * self.standing_rew()

    def compute_normalized_dense_reward(self, obs, action, info):
        return self.compute_dense_reward(obs, action, info)


@register_env("MS-AntWalk-v1", max_episode_steps=1000)
class AntWalkEnv(AntEnv):
    def __init__(self, *args, **kwargs):
        kwargs.pop("move_speed", None)
        super().__init__(*args, move_speed=_WALK_SPEED, **kwargs)


@register_env("MS-AntRun-v1", max_episode_steps=1000)
class AntRunEnv(AntEnv):
    def __init__(self, *args, **kwargs):
        kwargs.pop("move_speed", None)
        super().__init__(*args, move_speed=_RUN_SPEED, **kwargs)
