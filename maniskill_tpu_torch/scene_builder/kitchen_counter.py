"""Kitchen counter scene builder (counterpart of
maniskill_tpu/scene_builder/kitchen_counter.py).

A procedural unit: a countertop slab over a cabinet body with a backsplash,
whose top surface sits at ``COUNTER_TOP * scale``. The worksurface spans the
region the G1 pick-and-place task uses (the apple near xy (0, 0), the bowl
near y = -0.4, the robot standing clear at x = -0.3).
"""
from __future__ import annotations

import numpy as np

from ..building.ground import build_ground
from .scene_builder import SceneBuilder

# the counter top's height at scale 1.0 (the G1 task builds at scale 0.82)
COUNTER_TOP = 0.918


class KitchenCounterSceneBuilder(SceneBuilder):
    def build(self, scale: float = 1.0):
        scene = self.scene
        self.ground = build_ground(scene, altitude=0.0)
        top = COUNTER_TOP * scale
        b = scene.create_actor_builder()
        # the countertop slab: x in [-0.2, 0.8], y in [-0.75, 0.35] at scale 1
        slab = np.array([0.5, 0.55, 0.02]) * scale
        slab_c = np.array([0.3, -0.2]) * scale
        slab_pose = np.array([slab_c[0], slab_c[1], top - slab[2], 1, 0, 0, 0])
        b.add_box_collision(pose=slab_pose, half_size=slab, friction=0.6)
        b.add_box_visual(pose=slab_pose, half_size=slab, color=(0.85, 0.83, 0.80, 1.0))
        # the cabinet body under the slab, inset from the front edge
        bh = (top - 2.0 * slab[2]) / 2.0
        body = np.array([0.45 * scale, 0.52 * scale, bh])
        body_pose = np.array([0.35 * scale, slab_c[1], bh, 1, 0, 0, 0])
        b.add_box_collision(pose=body_pose, half_size=body, friction=0.6)
        b.add_box_visual(pose=body_pose, half_size=body, color=(0.55, 0.42, 0.32, 1.0))
        # the backsplash along the far (+x) edge
        back = np.array([0.015, 0.55, 0.25]) * scale
        b.add_box_visual(
            pose=np.array([0.8 * scale, slab_c[1], top + back[2], 1, 0, 0, 0]),
            half_size=back, color=(0.75, 0.73, 0.70, 1.0),
        )
        b.set_initial_pose(np.array([0, 0, 0, 1, 0, 0, 0]))
        self.counter = b.build_static("kitchen-counter")
        self.table = self.counter
        self.counter_top = top
        return self.counter

    def initialize(self, env_idx):
        pass
