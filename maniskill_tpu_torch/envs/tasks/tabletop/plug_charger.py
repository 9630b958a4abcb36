"""PlugCharger-v1 (counterpart of
maniskill_tpu/envs/tasks/tabletop/plug_charger.py).

Pick up a dual-peg charger and plug it into a floating kinematic
receptacle. All geometry is boxes: the charger is a base and two pegs, the
receptacle a slotted block of five boxes with 0.5 mm clearance. The goal is
the receptacle's pose turned by pi about z, derived in each ``evaluate``.
Success = the charger within 5 mm and 0.2 rad of the goal. Sparse reward.
"""
from __future__ import annotations

import numpy as np
import torch

from ....scene_builder.table import TableSceneBuilder
from ....sensors.camera import CameraConfig
from ....structs.pose import Pose
from ....structs.types import SceneConfig, SimConfig
from ....utils.geometry import rotation_conversions as rc
from ....utils.registration import register_env
from ....utils.scene_utils import look_at
from ...base_env import BaseEnv


@register_env("PlugCharger-v1", max_episode_steps=200)
class PlugChargerEnv(BaseEnv):
    SUPPORTED_ROBOTS = ["panda_wristcam", "panda"]
    SUPPORTED_REWARD_MODES = ("none", "sparse")

    _base_size = [2e-2, 1.5e-2, 1.2e-2]  # the charger base's half size
    _peg_size = [8e-3, 0.75e-3, 3.2e-3]  # a charger peg's half size
    _peg_gap = 7e-3
    _clearance = 5e-4
    _receptacle_size = [1e-2, 5e-2, 5e-2]

    def __init__(self, *args, robot_uids="panda_wristcam", robot_init_qpos_noise=0.02, **kwargs):
        self.robot_init_qpos_noise = robot_init_qpos_noise
        super().__init__(*args, robot_uids=robot_uids, **kwargs)

    @property
    def _default_sim_config(self):
        # a precision insertion: 32 solver iterations, so the grip holds the
        # charger still within the slot's clearance
        return SimConfig(scene_config=SceneConfig(solver_position_iterations=32))

    @property
    def _default_sensor_configs(self):
        pose = look_at(eye=[0.3, 0, 0.6], target=[-0.1, 0, 0.1])
        return [CameraConfig("base_camera", pose, 128, 128, np.pi / 2, 0.01, 100)]

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at([0.3, 0.4, 0.1], [0, 0, 0])
        return CameraConfig("render_camera", pose, 512, 512, 1, 0.01, 100)

    def _load_agent(self, options: dict):
        super()._load_agent(options, np.array([-0.615, 0, 0, 1, 0, 0, 0]))

    def _build_charger(self):
        peg, base, gap = self._peg_size, self._base_size, self._peg_gap
        b = self.scene.create_actor_builder()
        for sy in (gap, -gap):
            pose = np.array([peg[0], sy, 0, 1, 0, 0, 0])
            b.add_box_collision(pose=pose, half_size=peg)
            b.add_box_visual(pose=pose, half_size=peg, color=(0.8, 0.8, 0.82, 1))
        pose = np.array([-base[0], 0, 0, 1, 0, 0, 0])
        b.add_box_collision(pose=pose, half_size=base)
        b.add_box_visual(pose=pose, half_size=base, color=(0.1, 0.1, 0.12, 1))
        b.set_initial_pose(np.array([0, 0, self._base_size[2], 1, 0, 0, 0]))
        return b.build("charger")

    def _build_receptacle(self):
        peg = [self._peg_size[0], self._peg_size[1] + self._clearance, self._peg_size[2] + self._clearance]
        rec, gap = self._receptacle_size, self._peg_gap
        b = self.scene.create_actor_builder()
        sy = 0.5 * (rec[1] - peg[1] - gap)
        sz = 0.5 * (rec[2] - peg[2])
        dy = peg[1] + gap + sy
        dz = peg[2] + sz
        # four walls around the two slots and the strip between them
        parts = [
            ((0, dy, 0), [rec[0], sy, rec[2]]),
            ((0, -dy, 0), [rec[0], sy, rec[2]]),
            ((0, 0, dz), [rec[0], gap - peg[1], sz]),
            ((0, 0, -dz), [rec[0], gap - peg[1], sz]),
            ((0, 0, 0), [rec[0], gap - peg[1], peg[2]]),
        ]
        for pos, hs in parts:
            pose = np.array([*pos, 1, 0, 0, 0], np.float64)
            b.add_box_collision(pose=pose, half_size=hs)
            b.add_box_visual(pose=pose, half_size=hs, color=(0.9, 0.9, 0.92, 1))
        b.set_initial_pose(np.array([0.05, 0, 0.1, 1, 0, 0, 0]))
        return b.build_kinematic("receptacle")

    def _load_scene(self, options: dict):
        self.table_scene = TableSceneBuilder(self, robot_init_qpos_noise=self.robot_init_qpos_noise)
        self.table_scene.build()
        self.charger = self._build_charger()
        self.receptacle = self._build_receptacle()
        dev = self.device
        self._charger_lo = torch.tensor([-0.1, -0.2], device=dev)
        self._charger_span = torch.tensor([-0.01 - self._peg_size[0] * 2, 0.2], device=dev) - self._charger_lo
        self._receptacle_lo = torch.tensor([0.01, -0.1], device=dev)
        self._receptacle_span = torch.tensor([0.09, 0.2], device=dev)
        # the pose of a pi turn about z (wxyz)
        self._flip = Pose(torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0], device=dev))

    def _initialize_episode(self, env_idx: torch.Tensor, options: dict):
        self.table_scene.initialize(env_idx)
        rng = self._batched_episode_rng
        # the charger on the table, yawed
        xy = rng.uniform(0.0, 1.0, (2,)) * self._charger_span + self._charger_lo
        pos = torch.cat([xy, torch.full_like(xy[:, :1], self._base_size[2])], -1)
        q = rng.quaternions(lock_x=True, lock_y=True, bounds=(-np.pi / 3, np.pi / 3))
        self.charger.set_pose(Pose.create_from_pq(pos, q))
        # the floating receptacle, its slots facing the robot (yaw ~ pi)
        xy = rng.uniform(0.0, 1.0, (2,)) * self._receptacle_span + self._receptacle_lo
        pos = torch.cat([xy, torch.full_like(xy[:, :1], 0.1)], -1)
        q = rng.quaternions(lock_x=True, lock_y=True, bounds=(np.pi - np.pi / 8, np.pi + np.pi / 8))
        self.receptacle.set_pose(Pose.create_from_pq(pos, q))

    @property
    def goal_pose(self) -> Pose:
        """The charger's pose at full insertion: the receptacle's turned by pi
        about z."""
        return self.receptacle.pose * self._flip

    def evaluate(self):
        goal = self.goal_pose
        obj = self.charger.pose
        dist = torch.linalg.vector_norm(goal.p - obj.p, dim=-1)
        dq = rc.quaternion_multiply(rc.quaternion_conjugate(goal.q), obj.q)
        ang = torch.linalg.vector_norm(rc.quaternion_to_axis_angle(dq), dim=-1)
        ang = torch.minimum(ang, 2 * np.pi - ang)
        return dict(obj_to_goal_dist=dist, obj_to_goal_angle=ang, success=(dist <= 5e-3) & (ang <= 0.2))

    def _get_obs_extra(self, info: dict):
        obs = dict(tcp_pose=self.agent.tcp.pose.raw_pose)
        if "state" in self.obs_mode:
            obs.update(
                charger_pose=self.charger.pose.raw_pose,
                receptacle_pose=self.receptacle.pose.raw_pose,
                goal_pose=self.goal_pose.raw_pose,
            )
        return obs
