"""TableTopFreeDraw-v1 (counterpart of
maniskill_tpu/envs/tasks/drawing/draw.py).

A white canvas on the table; a stick-equipped Panda lays one red ink dot per
control step where its tip touches the canvas, up to ``MAX_DOTS``. No
success condition: a free-drawing sandbox.

The dots are dof-less kinematic markers whose poses are rows of
``Data.mocap_pose``; ``_after_control_step`` writes each env's dot at row
``min(draw_step, MAX_DOTS - 1)`` with one advanced-index write on the
device, and advances the per-env ``draw_step`` extra.
"""
from __future__ import annotations

import numpy as np
import torch

from ....scene_builder.table import TableSceneBuilder
from ....sensors.camera import CameraConfig
from ....structs.types import SceneConfig, SimConfig
from ....utils.registration import register_env
from ....utils.scene_utils import look_at
from ...base_env import BaseEnv

# dot orientation: the cylinder's axis turned to z-up (90 degrees about y)
_DOT_QUAT = np.array([np.cos(np.pi / 4), 0.0, np.sin(np.pi / 4), 0.0], np.float32)


@register_env("TableTopFreeDraw-v1", max_episode_steps=1000)
class TableTopFreeDrawEnv(BaseEnv):
    MAX_DOTS = 256
    """ink budget per episode (every dot is a marker row of the state)"""
    DOT_THICKNESS = 0.003
    CANVAS_THICKNESS = 0.02
    BRUSH_RADIUS = 0.01
    BRUSH_COLORS = [[0.8, 0.2, 0.2, 1]]

    SUPPORTED_REWARD_MODES = ("none",)
    SUPPORTED_ROBOTS = ["panda_stick"]

    def __init__(self, *args, robot_uids="panda_stick", max_dots=None, **kwargs):
        if max_dots is not None:
            self.MAX_DOTS = int(max_dots)
        super().__init__(*args, robot_uids=robot_uids, **kwargs)

    @property
    def _default_sim_config(self):
        return SimConfig(
            sim_freq=100, control_freq=20,
            scene_config=SceneConfig(solver_position_iterations=4, solver_velocity_iterations=0),
        )

    @property
    def _default_sensor_configs(self):
        pose = look_at(eye=[0.3, 0, 0.8], target=[0, 0, 0.1])
        return [CameraConfig("base_camera", pose, 320, 240, 1.2, 0.01, 100)]

    @property
    def _default_human_render_camera_configs(self):
        pose = look_at(eye=[0.3, 0, 0.8], target=[0, 0, 0.1])
        return CameraConfig("render_camera", pose, 640, 480, 1.2, 0.01, 100)

    def _load_agent(self, options: dict):
        super()._load_agent(options, np.array([-0.615, 0, 0, 1, 0, 0, 0]))

    def _load_scene(self, options: dict):
        self.table_scene = TableSceneBuilder(self, robot_init_qpos_noise=0)
        self.table_scene.build()

        b = self.scene.create_actor_builder()
        b.add_box_visual(half_size=[0.4, 0.6, self.CANVAS_THICKNESS / 2], color=[1, 1, 1, 1])
        b.add_box_collision(half_size=[0.4, 0.6, self.CANVAS_THICKNESS / 2])
        b.set_initial_pose([-0.1, 0, self.CANVAS_THICKNESS / 2, 1, 0, 0, 0])
        self.canvas = b.build_static(name="canvas")

        self.dots = []
        for i in range(self.MAX_DOTS):
            db = self.scene.create_actor_builder()
            db.add_cylinder_visual(
                radius=self.BRUSH_RADIUS, half_length=self.DOT_THICKNESS / 2, color=self.BRUSH_COLORS[0]
            )
            db.set_initial_pose(np.concatenate([[0, 0, -self.DOT_THICKNESS], _DOT_QUAT]))
            self.dots.append(db.build_kinematic(name=f"dot_{i}"))
        self.scene.register_extra("draw_step", (), torch.int32)

    def _after_reconfigure(self, options: dict):
        # the dots are dof-less markers: their poses are Data.mocap_pose rows
        idxs = [d._mocap_idx for d in self.dots]
        assert idxs == list(range(idxs[0], idxs[0] + len(idxs))), "dot mocap rows must be contiguous"
        self._dot_m0 = idxs[0]
        dev = self.device
        # a dot parked inside the table, and the row write's env index
        self._dot_hidden = torch.as_tensor(
            np.concatenate([[0, 0, -self.DOT_THICKNESS], _DOT_QUAT]).astype(np.float32), device=dev
        )
        self._env_ids = torch.arange(self.num_envs, device=dev)

    def _initialize_episode(self, env_idx: torch.Tensor, options: dict):
        self.table_scene.initialize(env_idx)
        # hide every dot inside the table
        d = self.scene.data
        m0 = self._dot_m0
        cur = d.mocap_pose[:, m0 : m0 + self.MAX_DOTS]
        mocap = d.mocap_pose.clone()
        mocap[:, m0 : m0 + self.MAX_DOTS] = self.scene.masked(self._dot_hidden.expand(cur.shape), cur)
        self.scene.data = d.replace(mocap_pose=mocap)

    def _touching(self, tcp: torch.Tensor) -> torch.Tensor:
        return tcp[:, 2] < self.CANVAS_THICKNESS + self.DOT_THICKNESS + 0.005

    def _after_control_step(self):
        scene = self.scene
        d = scene.data
        step = d.extras["draw_step"]  # (B,)
        tcp = self.agent.tcp_pose.p  # (B, 3)
        drawn = torch.cat(
            [tcp[:, :2], torch.full_like(tcp[:, :1], self.DOT_THICKNESS / 2 + self.CANVAS_THICKNESS),
             self._dot_hidden[3:].expand(tcp.shape[0], 4)], -1,
        )
        dot7 = torch.where(self._touching(tcp)[:, None], drawn, self._dot_hidden)  # (B, 7)
        mocap = d.mocap_pose.clone()
        mocap[self._env_ids, self._dot_m0 + torch.clamp(step, max=self.MAX_DOTS - 1).long()] = dot7
        scene.data = d.replace(mocap_pose=mocap, extras={**d.extras, "draw_step": step + 1})

    def _mark_hits(self, points: str):
        """Set the ``ref_hit`` extra of the reference points (the extra
        ``points``, (B, N, 2)) within ``THRESHOLD`` of a touching tip."""
        scene = self.scene
        d = scene.data
        tcp = self.agent.tcp_pose.p
        dist = torch.linalg.vector_norm(tcp[:, None, :2] - d.extras[points], dim=-1)  # (B, N)
        hit = d.extras["ref_hit"] | (self._touching(tcp)[:, None] & (dist < self.THRESHOLD))
        scene.data = d.replace(extras={**d.extras, "ref_hit": hit})

    def evaluate(self):
        return {}

    def _get_obs_extra(self, info: dict):
        return dict(tcp_pose=self.agent.tcp_pose.raw_pose)
