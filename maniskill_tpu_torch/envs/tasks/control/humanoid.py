"""Humanoid control tasks (counterpart of
maniskill_tpu/envs/tasks/control/humanoid.py: MS-HumanoidStand/Walk/Run-v1
and their Hard variants, after dm_control suite's humanoid).

The 21-dof humanoid is defined procedurally from dm_control's humanoid.xml
constants (capsule sizes, joint axes and ranges, passive damping and
stiffness classes, motor gears) on a free root. A multi-axis MJCF joint
becomes a chain of dummy bodies (1e-4 kg, inertia 1e-8), one hinge each;
the task math leaves the dummies (names ending in ``_d``) out.

Only the feet collide with the ground: every other link's pair with the
ground is excluded, so the torso-height fall test sees no limb contacts.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from ....agents.base_agent import BaseAgent
from ....agents.controllers import PDJointPosControllerConfig
from ....agents.registration import register_agent
from ....building.articulation_builder import ArticulationBuilder, LinkSpec, ShapeSpec
from ....building.ground import build_ground
from ....physics.types import FIXED, HINGE, SPHERE
from ....sensors.camera import CameraConfig
from ....structs.types import SceneConfig, SimConfig
from ....utils.geometry import rotation_conversions as rc
from ....utils.registration import register_env
from ....utils.scene_utils import look_at
from ...base_env import BaseEnv
from ...utils import rewards
from .hopper import _fromto_capsule, link_mass_table

# dm_control humanoid reward targets
_STAND_HEIGHT = 1.4
_WALK_SPEED = 1.0
_RUN_SPEED = 10.0

_DUMMY = dict(mass=1e-4, inertia=np.full(3, 1e-8))

# (joint, passive damping, passive stiffness) from humanoid.xml joint classes:
# body: d=.2 k=1; big_joint: d=5 k=10; big_stiff_joint: d=5 k=20; explicit
# ankle stiffness 6/3, elbow stiffness 0.
_PASSIVE = {
    "abdomen_z": (5.0, 20.0), "abdomen_y": (5.0, 10.0), "abdomen_x": (5.0, 10.0),
    "right_hip_x": (5.0, 10.0), "right_hip_z": (5.0, 10.0), "right_hip_y": (5.0, 20.0),
    "right_knee": (0.2, 1.0), "right_ankle_y": (0.2, 6.0), "right_ankle_x": (0.2, 3.0),
    "left_hip_x": (5.0, 10.0), "left_hip_z": (5.0, 10.0), "left_hip_y": (5.0, 20.0),
    "left_knee": (0.2, 1.0), "left_ankle_y": (0.2, 6.0), "left_ankle_x": (0.2, 3.0),
    "right_shoulder1": (0.2, 1.0), "right_shoulder2": (0.2, 1.0),
    "right_elbow": (0.2, 0.0),
    "left_shoulder1": (0.2, 1.0), "left_shoulder2": (0.2, 1.0),
    "left_elbow": (0.2, 0.0),
}

# motor gear (max torque at |ctrl|=1) and PD gains per joint (the upstream
# agent's drive properties)
_PD = {  # joint -> (stiffness, damping, force_limit)
    "abdomen_z": (40, 5, 40), "abdomen_y": (40, 5, 40), "abdomen_x": (40, 5, 40),
    "right_hip_x": (40, 5, 40), "right_hip_z": (40, 5, 40),
    "right_hip_y": (120, 5, 120), "right_knee": (80, 1, 80),
    "right_ankle_x": (20, 3, 20), "right_ankle_y": (40, 3, 20),
    "left_hip_x": (40, 5, 40), "left_hip_z": (40, 5, 40),
    "left_hip_y": (120, 5, 120), "left_knee": (80, 1, 80),
    "left_ankle_x": (20, 3, 20), "left_ankle_y": (40, 3, 20),
    "right_shoulder1": (20, 1, 20), "right_shoulder2": (20, 1, 20),
    "right_elbow": (40, 0, 40),
    "left_shoulder1": (20, 1, 20), "left_shoulder2": (20, 1, 20),
    "left_elbow": (40, 0, 40),
}
JOINT_ORDER = list(_PD.keys())


def _cap(a, b, r, friction=0.7):
    return _fromto_capsule(a, b, r, friction=friction)


@register_agent()
class HumanoidRobot(BaseAgent):
    """21-dof dm_control-style humanoid, also registered as an agent."""

    uid = "humanoid"
    fix_root_link = False  # free-floating root
    disable_self_collisions = True

    def build_description(self):
        b = ArticulationBuilder(self.scene)
        deg = np.deg2rad

        def hinge(name, parent, jname, origin, axis, rng=None, **kw):
            d, k = _PASSIVE[jname]
            lim = (deg(rng[0]), deg(rng[1])) if rng else (-np.inf, np.inf)
            b.add_link(
                LinkSpec(
                    name, parent, HINGE, jname, origin_pos=origin,
                    axis=tuple(np.asarray(axis, float) / np.linalg.norm(axis)),
                    limit=lim, damping=d, stiffness=k, armature=0.01, **kw,
                )
            )

        # torso: free root. Geoms in MJCF torso frame (off=0).
        torso_shapes = [
            _cap((0, -0.07, 0), (0, 0.07, 0), 0.07),
            _cap((-0.01, -0.06, -0.12), (-0.01, 0.06, -0.12), 0.06),
        ]
        b.add_link(LinkSpec("torso", None, collisions=torso_shapes, visuals=torso_shapes))
        head = [ShapeSpec(SPHERE, [0.09, 0, 0], friction=0.7)]
        b.add_link(
            LinkSpec("head", "torso", FIXED, "fix_head", origin_pos=(0, 0, 0.19),
                     collisions=head, visuals=head)
        )

        # lower_waist: abdomen_z + abdomen_y, both anchored at (0,0,.065) in
        # the MJCF child frame; body pos (-.01,0,-.260) -> chain anchor at
        # (-.01,0,-.195); geoms shift by -.065 in z.
        hinge("abdomen_z_d", "torso", "abdomen_z", (-0.01, 0, -0.195), (0, 0, 1),
              (-45, 45), **_DUMMY)
        lw = [_cap((0, -0.06, -0.065), (0, 0.06, -0.065), 0.06)]
        hinge("lower_waist", "abdomen_z_d", "abdomen_y", (0, 0, 0), (0, 1, 0),
              (-75, 30), collisions=lw, visuals=lw)

        # pelvis: abdomen_x at (0,0,.1); MJCF pos (0,0,-.165), parent frame
        # offset .065 -> origin (0,0,-.13); butt geom shifts by -.1.
        butt = [_cap((-0.02, -0.07, -0.1), (-0.02, 0.07, -0.1), 0.09)]
        hinge("pelvis", "lower_waist", "abdomen_x", (0, 0, -0.13), (1, 0, 0),
              (-35, 35), collisions=butt, visuals=butt)

        # legs: thigh carries hip_x->hip_z->hip_y chain; MJCF pos (0,±.1,-.04)
        # from pelvis (offset .1) -> origin (0,±.1,-.14).
        for side, sgn, hipx_ax, hipz_ax, hipy_rng in (
            ("right", -1.0, (1, 0, 0), (0, 0, 1), (-110, 20)),
            ("left", 1.0, (-1, 0, 0), (0, 0, -1), (-120, 20)),
        ):
            hinge(f"{side}_hip_x_d", "pelvis", f"{side}_hip_x",
                  (0, 0.1 * sgn, -0.14), hipx_ax, (-25, 5), **_DUMMY)
            hinge(f"{side}_hip_z_d", f"{side}_hip_x_d", f"{side}_hip_z",
                  (0, 0, 0), hipz_ax, (-60, 35), **_DUMMY)
            thigh = [_cap((0, 0, 0), (0, -0.01 * sgn, -0.34), 0.06)]
            hinge(f"{side}_thigh", f"{side}_hip_z_d", f"{side}_hip_y",
                  (0, 0, 0), (0, 1, 0), hipy_rng, collisions=thigh, visuals=thigh)
            # shin: knee at (0,0,.02); MJCF pos (0,∓.01,-.403) -> origin
            # (0,∓.01,-.383); geom shifts -.02.
            shin = [_cap((0, 0, -0.02), (0, 0, -0.32), 0.049)]
            hinge(f"{side}_shin", f"{side}_thigh", f"{side}_knee",
                  (0, -0.01 * sgn, -0.383), (0, -1, 0), (-160, 2),
                  collisions=shin, visuals=shin)
            # foot: ankle_y at (0,0,.08), ankle_x at (0,0,.04); MJCF pos
            # (0,0,-.39), parent offset .02 -> ankle_y anchor at (0,0,-.33);
            # geoms shift by -.04.
            hinge(f"{side}_ankle_y_d", f"{side}_shin", f"{side}_ankle_y",
                  (0, 0, -0.33), (0, 1, 0), (-50, 50), **_DUMMY)
            foot = [
                _cap((-0.07, -0.02 * -sgn, -0.04), (0.14, -0.04 * -sgn, -0.04), 0.027, friction=1.0),
                _cap((-0.07, 0, -0.04), (0.14, 0.02 * -sgn, -0.04), 0.027, friction=1.0),
            ]
            hinge(f"{side}_foot", f"{side}_ankle_y_d", f"{side}_ankle_x",
                  (0, 0, -0.04), (1, 0, 0.5), (-50, 50),
                  collisions=foot, visuals=foot)

        # arms: shoulder1 -> shoulder2 chain at MJCF pos (0,±.17,.06) on torso
        for side, sgn, s1_ax, s2_ax, s_rng, el_ax in (
            ("right", -1.0, (2, 1, 1), (0, -1, 1), (-85, 60), (0, -1, 1)),
            ("left", 1.0, (2, -1, 1), (0, 1, 1), (-60, 85), (0, -1, -1)),
        ):
            hinge(f"{side}_shoulder1_d", "torso", f"{side}_shoulder1",
                  (0, 0.17 * sgn, 0.06), s1_ax, s_rng, **_DUMMY)
            uarm = [_cap((0, 0, 0), (0.16, 0.16 * sgn, -0.16), 0.04)]
            hinge(f"{side}_upper_arm", f"{side}_shoulder1_d", f"{side}_shoulder2",
                  (0, 0, 0), s2_ax, s_rng, collisions=uarm, visuals=uarm)
            larm = [_cap((0.01, -0.01 * sgn, 0.01), (0.17, -0.17 * sgn, 0.17), 0.031)]
            hinge(f"{side}_lower_arm", f"{side}_upper_arm", f"{side}_elbow",
                  (0.18, 0.18 * sgn, -0.18), el_ax, (-90, 50),
                  collisions=larm, visuals=larm)
            hand = [ShapeSpec(SPHERE, [0.04, 0, 0], friction=0.7)]
            b.add_link(
                LinkSpec(f"{side}_hand", f"{side}_lower_arm", FIXED,
                         f"fix_{side}_hand", origin_pos=(0.18, -0.18 * sgn, 0.18),
                         collisions=hand, visuals=hand)
            )
        return b

    @property
    def _controller_configs(self):
        kp = [_PD[j][0] for j in JOINT_ORDER]
        kd = [_PD[j][1] for j in JOINT_ORDER]
        fl = [_PD[j][2] for j in JOINT_ORDER]
        pd_joint_pos = PDJointPosControllerConfig(
            joint_names=JOINT_ORDER, lower=None, upper=None,
            stiffness=100, damping=10, normalize_action=False,
        )
        pd_joint_delta_pos = PDJointPosControllerConfig(
            joint_names=JOINT_ORDER, lower=-1, upper=1,
            stiffness=kp, damping=kd, force_limit=fl, use_delta=True,
        )
        return dict(
            pd_joint_delta_pos=dict(
                body=pd_joint_delta_pos, balance_passive_force=False
            ),
            pd_joint_pos=dict(body=pd_joint_pos, balance_passive_force=False),
        )


class HumanoidEnv(BaseEnv):
    """The humanoid tasks' shared scene, state, obs and reward terms."""

    agent: HumanoidRobot
    SUPPORTED_REWARD_MODES = ("normalized_dense", "dense", "none")

    def __init__(self, *args, robot_uids=HumanoidRobot, **kwargs):
        super().__init__(*args, robot_uids=robot_uids, **kwargs)

    @property
    def _default_sim_config(self):
        return SimConfig(sim_freq=200, control_freq=40,
                         scene_config=SceneConfig(solver_position_iterations=12))

    @property
    def _default_sensor_configs(self):
        pose = look_at(eye=[0, -3, 1], target=[0, 0, 0.8])
        return [CameraConfig("base_camera", pose, 128, 128, np.pi / 2, 0.01, 100)]

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at([0, -4, 1.5], [0, 0, 0.8])
        return CameraConfig("render_camera", pose, 512, 512, 1, 0.01, 100)

    def _load_scene(self, options: dict):
        self.ground = build_ground(self.scene, friction=1.0)
        # every robot-ground pair is excluded except the feet's
        mb = self.scene.mb
        for link in self.agent.robot.links:
            if "foot" not in link.name:
                mb.exclude_collision(self.ground.body_id, link.body_id)

    def _after_reconfigure(self, options: dict):
        links = [link for link in self.agent.robot.links if not link.name.endswith("_d")]
        self._link_ids, self._link_masses, self._robot_mass = link_mass_table(self, links)
        self._start_pose = torch.tensor([0, 0, 1.3, 1, 0, 0, 0], dtype=torch.float32, device=self.device)

    def _initialize_episode(self, env_idx, options: dict):
        rng = self._batched_episode_rng
        robot = self.agent.robot
        noise = 1e-2
        qpos = noise * (2 * rng.uniform(0.0, 1.0, (robot.dof,)) - 1)
        qvel = noise * (2 * rng.uniform(0.0, 1.0, (robot.dof,)) - 1)
        robot.set_root_pose(self._start_pose)
        robot.set_qpos(qpos)
        robot.set_qvel(qvel)
        self.agent.controller.reset()

    # -- per-step quantities ----------------------------------------------
    @property
    def head_height(self):
        return self.agent.robot.links_map["head"].pose.p[:, -1]

    def torso_xmat(self):
        return rc.quaternion_to_matrix(self.agent.robot.links_map["torso"].pose.q)

    @property
    def center_of_mass_velocity(self):
        vels = self.scene.data.cvel[:, self._link_ids, :3]  # (B, L, 3)
        return torch.sum(vels * self._link_masses[None, :, None], 1) / self._robot_mass

    def extremities(self, info):
        R = info["torso_xmat"]  # (B, 3, 3) world <- torso
        links = self.agent.robot.links_map
        torso_p = links["torso"].pose.p
        cols = []
        for side in ("left_", "right_"):
            for limb in ("hand", "foot"):
                d = links[side + limb].pose.p - torso_p
                cols.append(torch.einsum("bij,bi->bj", R, d))  # R^T d: the torso frame
        return torch.cat(cols, -1)  # (B, 12)

    def evaluate(self):
        info = dict(torso_xmat=self.torso_xmat(), cmass_linvel=self.center_of_mass_velocity)
        torso_z = self.agent.robot.links_map["torso"].pose.p[:, -1]
        info["fail"] = (torso_z < 0.7) | (torso_z > 2.0)
        return info

    def _get_obs_state_dict(self, info: dict):
        cvel = self.scene.data.cvel[:, self._link_ids]
        B = self.num_envs
        return dict(
            agent=self._get_obs_agent(),
            head_height=self.head_height[:, None],
            com_velocity=info["cmass_linvel"],
            extremities=self.extremities(info),
            link_linvels=cvel[..., :3].reshape(B, -1),
            link_angvels=cvel[..., 3:].reshape(B, -1),
            orient=self.agent.robot.links_map["torso"].pose.q,
        )

    # -- reward terms -------------------------------------------------------
    def control_rew(self, action):
        return torch.mean(rewards.tolerance(action, margin=1, value_at_margin=0, sigmoid="quadratic"), -1)

    def dont_move_rew(self, info):
        return torch.mean(rewards.tolerance(info["cmass_linvel"][:, :2], margin=2), -1)

    def move_x_rew(self, info, move_speed):
        return rewards.tolerance(info["cmass_linvel"][:, 0], lower=move_speed, upper=math.inf,
                                 margin=move_speed, value_at_margin=0, sigmoid="linear")

    def standing_rew(self):
        return rewards.tolerance(self.head_height, lower=_STAND_HEIGHT, upper=math.inf,
                                 margin=_STAND_HEIGHT / 4)

    def upright_rew(self, info):
        return rewards.tolerance(info["torso_xmat"][:, 2, 2], lower=0.9, upper=math.inf,
                                 sigmoid="linear", margin=1.9, value_at_margin=0)

    def compute_dense_reward(self, obs, action, info):
        return self.compute_normalized_dense_reward(obs, action, info)


@register_env("MS-HumanoidStand-v1", max_episode_steps=1000)
class HumanoidStand(HumanoidEnv):
    """Stand upright; a random yaw at reset."""

    def _initialize_episode(self, env_idx, options: dict):
        super()._initialize_episode(env_idx, options)
        half = self._batched_episode_rng.uniform(0.0, 2 * math.pi) / 2
        zeros = torch.zeros_like(half)
        root = torch.stack([zeros, zeros, torch.full_like(half, 1.3),
                            torch.cos(half), zeros, zeros, torch.sin(half)], -1)
        self.agent.robot.set_root_pose(root)

    def compute_normalized_dense_reward(self, obs: Any, action, info: dict):
        small_control = (4 + self.control_rew(action)) / 5
        return small_control * self.standing_rew() * self.upright_rew(info) * self.dont_move_rew(info)


@register_env("MS-HumanoidWalk-v1", max_episode_steps=1000)
class HumanoidWalk(HumanoidEnv):
    """Move in +x at walking pace."""

    def compute_normalized_dense_reward(self, obs: Any, action, info: dict):
        small_control = (4 + self.control_rew(action)) / 5
        walk = small_control * self.move_x_rew(info, _WALK_SPEED) * self.upright_rew(info) * self.standing_rew()
        return (1.0 + walk) / 2


@register_env("MS-HumanoidRun-v1", max_episode_steps=1000)
class HumanoidRun(HumanoidEnv):
    """Move in +x at running pace."""

    def compute_normalized_dense_reward(self, obs: Any, action, info: dict):
        small_control = (4 + self.control_rew(action)) / 5
        run = small_control * self.move_x_rew(info, _RUN_SPEED) * self.upright_rew(info) * self.standing_rew()
        return (1.0 + run) / 2


class HumanoidEnvHard(HumanoidEnv):
    """The Hard variants: a random root orientation and a uniform qpos within
    the joint limits at reset, the root's velocities in the obs, and no fall
    test (recovering from any state is the task)."""

    def _after_reconfigure(self, options: dict):
        super()._after_reconfigure(options)
        self._start_xyz = torch.tensor([0.0, 0.0, 1.5], device=self.device)

    def _initialize_episode(self, env_idx, options: dict):
        rng = self._batched_episode_rng
        robot = self.agent.robot
        lim = robot.qlimits  # (B, dof, 2)
        lo, hi = lim[..., 0], lim[..., 1]
        u = rng.uniform(0.0, 1.0, (robot.dof,))
        robot.set_qpos(lo + u * (hi - lo))
        robot.set_qvel(torch.zeros_like(u))
        q = rng.quaternions()
        robot.set_root_pose(torch.cat([self._start_xyz.expand(self.num_envs, 3), q], -1))
        self.agent.controller.reset()

    def _get_obs_state_dict(self, info: dict):
        obs = super()._get_obs_state_dict(info)
        torso = self.agent.robot.links_map["torso"]
        obs.update(root_vel=torso.linear_velocity, root_quat_vel=torso.angular_velocity)
        return obs

    def evaluate(self):
        return dict(torso_xmat=self.torso_xmat(), cmass_linvel=self.center_of_mass_velocity)


@register_env("MS-HumanoidStandHard-v1", max_episode_steps=1000)
class HumanoidStandHard(HumanoidEnvHard):
    def compute_normalized_dense_reward(self, obs: Any, action, info: dict):
        small_control = (4 + self.control_rew(action)) / 5
        return small_control * self.standing_rew() * self.upright_rew(info) * self.dont_move_rew(info)


@register_env("MS-HumanoidWalkHard-v1", max_episode_steps=1000)
class HumanoidWalkHard(HumanoidEnvHard):
    def compute_normalized_dense_reward(self, obs: Any, action, info: dict):
        small_control = (4 + self.control_rew(action)) / 5
        return small_control * self.standing_rew() * self.upright_rew(info) * self.move_x_rew(info, _WALK_SPEED)


@register_env("MS-HumanoidRunHard-v1", max_episode_steps=1000)
class HumanoidRunHard(HumanoidEnvHard):
    def compute_normalized_dense_reward(self, obs: Any, action, info: dict):
        small_control = (4 + self.control_rew(action)) / 5
        return small_control * self.standing_rew() * self.upright_rew(info) * self.move_x_rew(info, _RUN_SPEED)
