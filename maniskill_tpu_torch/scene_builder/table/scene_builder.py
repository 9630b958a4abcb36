"""Table scene builder (counterpart of
maniskill_tpu/scene_builder/table/scene_builder.py).

Builds a ground plane + table whose top surface is exactly z=0 (tasks place
objects at z=half_size), and initializes each robot at its keyframe pose
with small qpos noise.
"""
from __future__ import annotations

import numpy as np
import torch

from ...building.ground import build_ground
from ...render.textures import wood
from ..scene_builder import SceneBuilder

TABLE_HEIGHT = 0.9196429  # reference table model height


class TableSceneBuilder(SceneBuilder):
    def build(self):
        scene = self.scene
        self.ground = build_ground(scene, altitude=-TABLE_HEIGHT)
        b = scene.create_actor_builder()
        half = np.array([0.7, 0.8, 0.025])
        b.add_box_collision(
            pose=np.array([0, 0, -half[2], 1, 0, 0, 0]), half_size=half, friction=0.3
        )
        b.add_box_visual(
            pose=np.array([0, 0, -half[2], 1, 0, 0, 0]),
            half_size=half,
            color=(0.57, 0.43, 0.30, 1.0),
        )
        # wood-grain top: a baked-texture grid just above the box face
        b.add_textured_visual(
            wood(64), half[0], half[1], pose=np.array([0, 0, 5e-4, 1, 0, 0, 0]), res=10,
        )
        b.set_initial_pose(np.array([-0.12, 0, 0, 1, 0, 0, 0]))
        self.table = b.build_static("table-workspace")
        self.table_height = TABLE_HEIGHT
        # per agent: its rest qpos and noise mask on the device once (a
        # host-to-device copy in every reset would stall the rollout's
        # masked resets), or None without a rest keyframe
        self._rest = []
        for agent in getattr(self.env.agent, "agents", [self.env.agent]):
            kf = agent.keyframes.get("rest")
            if kf is None or kf.qpos is None:
                self._rest.append((agent, None, None))
                continue
            qpos = torch.as_tensor(np.asarray(kf.qpos, np.float32), device=self.env.device)
            # the gripper joints stay exactly at the keyframe
            mask = torch.ones(len(kf.qpos), device=self.env.device)
            if len(kf.qpos) >= 2:
                mask[-2:] = 0.0
            self._rest.append((agent, qpos, mask))

    def initialize(self, env_idx):
        rng = self.env._batched_episode_rng
        for agent, qpos, mask in self._rest:
            if qpos is None:
                agent.reset()
                continue
            noise = rng.normal(0.0, self.robot_init_qpos_noise, size=(qpos.shape[0],))
            agent.reset(qpos + noise * mask)
