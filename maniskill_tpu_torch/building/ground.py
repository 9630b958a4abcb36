"""Ground plane builder (counterpart of maniskill_tpu/building/ground.py)."""
from __future__ import annotations

import numpy as np


def build_ground(
    scene,
    altitude: float = 0.0,
    name: str = "ground",
    friction: float = 1.0,
    color=(0.3, 0.3, 0.3, 1.0),
):
    builder = scene.create_actor_builder()
    # plane local +z is the contact normal
    pose = np.array([0.0, 0.0, altitude, 1.0, 0.0, 0.0, 0.0])
    builder.add_plane_collision(pose=pose, friction=friction)
    builder.add_plane_visual(pose=pose, color=color)
    return builder.build_static(name)
