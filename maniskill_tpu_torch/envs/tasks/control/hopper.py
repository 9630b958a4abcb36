"""Hopper control tasks (counterpart of
maniskill_tpu/envs/tasks/control/hopper.py, dm_control planar hopper).

The planar hopper is defined procedurally from the dm_control hopper.xml
constants: a slide-x/slide-z/hinge-y planar root (a chain of dummy bodies
under a fixed anchor, one joint per body) carrying torso, pelvis, thigh,
calf and foot.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ....agents.base_agent import BaseAgent
from ....agents.controllers import PassiveControllerConfig, PDJointPosControllerConfig
from ....building.articulation_builder import ArticulationBuilder, LinkSpec, ShapeSpec
from ....building.ground import build_ground
from ....physics.types import CAPSULE, FIXED, HINGE, SLIDE
from ....sensors.camera import CameraConfig
from ....structs.types import SceneConfig, SimConfig
from ....utils.registration import register_env
from ....utils.scene_utils import look_at
from ...base_env import BaseEnv
from ...utils import rewards

_STAND_HEIGHT = 0.6
_HOP_SPEED = 2.0


def _fromto_capsule(a, b, r, friction=1.0):
    """Capsule between two points in the body frame (MJCF fromto semantics)."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    mid = (a + b) / 2
    d = b - a
    length = np.linalg.norm(d)
    if length < 1e-9:
        quat = np.array([1.0, 0, 0, 0])
    else:
        z = d / length
        v = np.cross([0, 0, 1.0], z)
        q = np.array([1.0 + z[2], *v])
        n = np.linalg.norm(q)
        quat = q / n if n > 1e-9 else np.array([0.0, 1.0, 0, 0])
    return ShapeSpec(CAPSULE, [r, length / 2, 0], mid, quat, friction=friction)


def link_mass_table(env, links):
    """(link body ids (L,) on the env's device, their masses (L,) there, the
    links' total mass as a float), read from the model's host mirror."""
    masses = np.asarray(env.scene.model.host_body_mass, np.float32)
    ids = np.array([link.body_id for link in links])
    return (torch.as_tensor(ids, device=env.device), torch.as_tensor(masses[ids], device=env.device),
            float(masses[ids].sum()))


class HopperRobot(BaseAgent):
    uid = "hopper"
    fix_root_link = True
    disable_self_collisions = True

    def build_description(self):
        b = ArticulationBuilder(self.scene)
        deg = np.deg2rad
        dummy = dict(mass=1e-4, inertia=np.full(3, 1e-8))

        def part(name, parent, jname, origin, lim, fromto, r):
            shapes = [_fromto_capsule(*fromto, r)]
            b.add_link(LinkSpec(name, parent, HINGE, jname, origin_pos=origin, axis=(0, 1, 0),
                                limit=(deg(lim[0]), deg(lim[1])), damping=0.05, armature=0.2,
                                collisions=shapes, visuals=list(shapes)))

        # planar root: x-slide -> z-slide -> y-hinge chain of dummy bodies
        b.add_link(LinkSpec("world_anchor", None))
        b.add_link(LinkSpec("rootx", "world_anchor", SLIDE, "rootx", axis=(1, 0, 0), origin_pos=(0, 0, 1.0), **dummy))
        b.add_link(LinkSpec("rootz", "rootx", SLIDE, "rootz", axis=(0, 0, 1), **dummy))
        torso = [_fromto_capsule((0, 0, -0.05), (0, 0, 0.2), 0.0653),
                 _fromto_capsule((0.08, 0, 0.13), (0.15, 0, 0.14), 0.03)]
        b.add_link(LinkSpec("torso", "rootz", HINGE, "rooty", axis=(0, 1, 0),
                            collisions=torso, visuals=list(torso)))
        part("pelvis", "torso", "waist", (0, 0, -0.05), (-30, 30), ((0, 0, 0), (0, 0, -0.15)), 0.065)
        part("thigh", "pelvis", "hip", (0, 0, -0.2), (-144, 10), ((0, 0, 0), (0, 0, -0.33)), 0.04)
        part("calf", "thigh", "knee", (0, 0, -0.33), (5, 150), ((0, 0, 0), (0, 0, -0.32)), 0.03)
        part("foot_heel", "calf", "ankle", (0, 0, -0.32), (-45, 45), ((-0.08, 0, 0), (0.11, 0, 0)), 0.04)
        toe = [_fromto_capsule((0.11, 0, 0), (0.17, 0, 0), 0.04)]
        b.add_link(LinkSpec("foot_toe", "foot_heel", joint_type=FIXED, joint_name="fix_toe2heel",
                            collisions=toe, visuals=list(toe)))
        return b

    @property
    def _controller_configs(self):
        max_delta = 2
        body = PDJointPosControllerConfig(
            joint_names=["hip", "knee", "waist"], lower=-max_delta, upper=max_delta,
            damping=10, stiffness=100, use_delta=True,
        )
        ankle = PDJointPosControllerConfig(
            joint_names=["ankle"], lower=-max_delta / 2.5, upper=max_delta / 2.5,
            damping=10, stiffness=100, use_delta=True,
        )
        rest = PassiveControllerConfig(joint_names=["rootx", "rootz", "rooty"], damping=0, friction=0)
        return dict(pd_joint_delta_pos=dict(body=body, ankle=ankle, rest=rest, balance_passive_force=False))

    def get_proprioception(self):
        # the x-slider's qpos is left out: the task is invariant to x
        return dict(qpos=self.robot.qpos[:, 1:], qvel=self.robot.qvel)


class HopperEnv(BaseEnv):
    agent: HopperRobot

    def __init__(self, *args, robot_uids=HopperRobot, **kwargs):
        super().__init__(*args, robot_uids=robot_uids, **kwargs)

    @property
    def _default_sim_config(self):
        return SimConfig(sim_freq=200, control_freq=40,
                         scene_config=SceneConfig(solver_position_iterations=8))

    @property
    def _default_sensor_configs(self):
        pose = look_at(eye=[0, -2.8, 0.8], target=[0, 0, 0.5])
        return [CameraConfig("base_camera", pose, 128, 128, np.pi / 2, 0.01, 100)]

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at([0, -3, 1], [0, 0, 0.5])
        return CameraConfig("render_camera", pose, 512, 512, 1, 0.01, 100)

    def _load_scene(self, options: dict):
        self.ground = build_ground(self.scene, friction=1.0)

    def _after_reconfigure(self, options: dict):
        robot = self.agent.robot
        # the dummy anchor and slider bodies carry no mass of the robot
        self._link_ids, self._link_masses, self._robot_mass = link_mass_table(self, robot.links[3:])
        lims = np.asarray(self.scene.model.host_dof_limit)[[j.dof_adr for j in robot.active_joints]]
        self._qpos_lo = torch.as_tensor(np.clip(lims[:, 0], -np.pi, np.pi), dtype=torch.float32,
                                        device=self.device)
        self._qpos_hi = torch.as_tensor(np.clip(lims[:, 1], -np.pi, np.pi), dtype=torch.float32,
                                        device=self.device)

    def _initialize_episode(self, env_idx, options: dict):
        rng = self._batched_episode_rng
        u = rng.uniform(0.0, 1.0, (self.agent.robot.dof,))
        qpos = self._qpos_lo + u * (self._qpos_hi - self._qpos_lo)
        qpos[:, 0:2] = 0.0
        qpos[:, 2] = math.pi * (2 * rng.uniform(0.0, 1.0) - 1)
        self.agent.reset(qpos)

    @property
    def height(self):
        links = self.agent.robot.links_map
        return links["torso"].pose.p[:, -1] - links["foot_heel"].pose.p[:, -1]

    @property
    def subtreelinvelx(self):
        vels = self.scene.data.cvel[:, self._link_ids, 0]  # (B, links)
        return torch.sum(vels * self._link_masses, 1) / self._robot_mass

    def touch(self, link_name):
        force = self.agent.robot.links_map[link_name].get_net_contact_forces()
        return torch.log1p(torch.linalg.vector_norm(force, dim=-1))

    def _get_obs_state_dict(self, info: dict):
        return dict(
            agent=self._get_obs_agent(),
            toe_touch=self.touch("foot_toe"),
            heel_touch=self.touch("foot_heel"),
        )

    def evaluate(self):
        return {}


@register_env("MS-HopperStand-v1", max_episode_steps=600)
class HopperStandEnv(HopperEnv):
    def compute_dense_reward(self, obs, action, info):
        return rewards.tolerance(self.height, lower=_STAND_HEIGHT, upper=2.0)

    def compute_normalized_dense_reward(self, obs, action, info):
        return self.compute_dense_reward(obs, action, info)


@register_env("MS-HopperHop-v1", max_episode_steps=600)
class HopperHopEnv(HopperEnv):
    def compute_dense_reward(self, obs, action, info):
        standing = rewards.tolerance(self.height, lower=_STAND_HEIGHT, upper=2.0)
        hopping = rewards.tolerance(
            self.subtreelinvelx, lower=_HOP_SPEED, upper=math.inf,
            margin=_HOP_SPEED / 2, value_at_margin=0.5, sigmoid="linear",
        )
        return standing * (5 * hopping + 1) / 6

    def compute_normalized_dense_reward(self, obs, action, info):
        return self.compute_dense_reward(obs, action, info)
