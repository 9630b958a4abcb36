"""RoboCasa kitchen scene builder (counterpart of
maniskill_tpu/scene_builder/robocasa/scene_builder.py).

Assembles a whole kitchen from the procedural fixture library along one of
five floor plans (one_wall, one_wall_large, l_shaped, galley, u_shaped),
each a list of wall runs, each run a sequence of fixtures placed side by
side. Articulated fixtures (cabinets, drawers, fridge, stove, dishwasher)
expose their joints for tasks. The spawn tables (counter slots and named
regions) are copied to the device once per build, so a reset samples
positions without a host-to-device copy.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ...building.ground import build_ground
from ..registration import register_scene_builder
from ..scene_builder import SceneBuilder
from . import fixtures as F


def _run_layout(scene, run, created, counters):
    """Place a wall run: ``run`` = (origin_xy, direction_deg, [fixtures]).

    Each fixture spec: (kind, width, kwargs). Fixtures are placed
    side-by-side along the run direction, fronts facing +90 deg from it.
    """
    (ox, oy), ddeg, specs = run
    d = np.deg2rad(ddeg)
    dirv = np.array([np.cos(d), np.sin(d)])
    face_yaw = d - np.pi / 2  # fixture +x (front) points into the room
    offset = 0.0
    for kind, width, kwargs in specs:
        center = np.array([ox, oy]) + dirv * (offset + width / 2)
        name = kwargs.pop("name", f"{kind}_{len(created)}")
        builder = getattr(F, f"build_{kind}")
        if kind in ("counter", "cabinet", "drawer_stack", "sink", "stove",
                    "dishwasher"):
            kwargs.setdefault("width", width)
        obj = builder(scene, name, center, yaw=face_yaw, **kwargs)
        created[name] = obj
        created.setdefault("_positions", {})[name] = (center, face_yaw)
        if kind in ("counter", "sink"):
            counters.append((center, face_yaw, width))
        offset += width
    return offset


# each layout: list of runs. Fixture fronts face the room interior.
LAYOUTS = {
    "one_wall": [
        ((-1.5, -1.2), 90.0, [
            ("counter", 0.8, {}),
            ("sink", 0.76, {}),
            ("drawer_stack", 0.6, {}),
            ("stove", 0.76, {}),
            ("counter", 0.8, {}),
        ]),
    ],
    "one_wall_large": [
        ((-2.0, -1.8), 90.0, [
            ("fridge", 0.8, {}),
            ("counter", 0.8, {}),
            ("sink", 0.76, {}),
            ("cabinet", 0.6, {}),
            ("stove", 0.76, {}),
            ("dishwasher", 0.6, {}),
            ("counter", 0.8, {}),
        ]),
    ],
    "l_shaped": [
        ((-1.8, -1.8), 90.0, [
            ("counter", 0.8, {}),
            ("sink", 0.76, {}),
            ("cabinet", 0.6, {}),
            ("counter", 0.8, {}),
        ]),
        ((-1.8, -1.8), 0.0, [
            ("fridge", 0.8, {}),
            ("counter", 0.8, {}),
            ("stove", 0.76, {}),
            ("drawer_stack", 0.6, {}),
        ]),
    ],
    "galley": [
        ((-1.4, -1.6), 90.0, [
            ("counter", 0.8, {}),
            ("sink", 0.76, {}),
            ("dishwasher", 0.6, {}),
            ("counter", 0.8, {}),
        ]),
        ((1.4, 1.6), 270.0, [
            ("counter", 0.8, {}),
            ("stove", 0.76, {}),
            ("drawer_stack", 0.6, {}),
            ("fridge", 0.8, {}),
        ]),
    ],
    "u_shaped": [
        ((-1.8, -1.5), 90.0, [
            ("counter", 0.8, {}),
            ("sink", 0.76, {}),
            ("counter", 0.8, {}),
        ]),
        ((-1.8, -1.5), 0.0, [
            ("counter", 0.7, {}),
            ("stove", 0.76, {}),
            ("counter", 0.7, {}),
        ]),
        ((-1.8, 1.5), 0.0, [
            ("fridge", 0.8, {}),
            ("dishwasher", 0.6, {}),
            ("counter", 0.8, {}),
        ]),
    ],
}


@register_scene_builder("RoboCasa")
class RoboCasaSceneBuilder(SceneBuilder):
    build_configs: List[str] = list(LAYOUTS)
    # open kitchen floor, facing the y=0 counter run (+y, yaw=90deg)
    robot_initial_pose = np.array([0.0, -1.0, 0.02, 0.7071068, 0, 0, 0.7071068])

    def build(self, build_config_idxs: Optional[List[int]] = None):
        idx = (build_config_idxs or [0])[0]
        layout = self.build_configs[idx % len(self.build_configs)]
        scene = self.scene
        self.ground = build_ground(scene, friction=0.9)
        self.fixtures = {}
        self.counter_slots = []  # (center_xy, yaw, width) of counter tops
        for run in LAYOUTS[layout]:
            _run_layout(scene, run, self.fixtures, self.counter_slots)
        positions = self.fixtures.pop("_positions", {})
        self.fixture_positions = positions
        # vent hood above each stove
        for name in list(self.fixtures):
            if name.startswith("stove") and name in positions:
                center, yaw = positions[name]
                F.build_hood(scene, name + "_hood", center, yaw=yaw)
        # second tier: uppers/shelves over counters, window over the sink,
        # small appliances on counters (reference fixture_stack/accessories)
        k = 0
        for name, (center, yaw) in list(positions.items()):
            back = center - 0.22 * np.array([np.cos(yaw), np.sin(yaw)])
            if name.startswith("counter"):
                if k % 2 == 0:
                    self.fixtures[f"upper_{k}"] = F.build_upper_cabinet(
                        scene, f"upper_{k}", back, yaw=yaw, width=0.7
                    )
                else:
                    self.fixtures[f"shelf_{k}"] = F.build_open_shelf(
                        scene, f"shelf_{k}", back, yaw=yaw, width=0.7
                    )
                if k == 0:
                    self.fixtures["toaster"] = F.build_toaster(
                        scene, "toaster",
                        center - 0.12 * np.array([np.cos(yaw), np.sin(yaw)]),
                        yaw=yaw,
                    )
                elif k == 1:
                    self.fixtures["coffee_machine"] = F.build_coffee_machine(
                        scene, "coffee_machine",
                        center - 0.12 * np.array([np.cos(yaw), np.sin(yaw)]),
                        yaw=yaw,
                    )
                k += 1
            elif name.startswith("sink"):
                self.fixtures["window"] = F.build_window(
                    scene, "window", back - 0.12 * np.array(
                        [np.cos(yaw), np.sin(yaw)]
                    ), yaw=yaw
                )
        # named spawn regions (reference spawn-group analog): region ->
        # (center_xy, yaw, half_extents_xy, z_top)
        self.regions = {}
        for name, (center, yaw) in positions.items():
            if name.startswith("sink"):
                self.regions["sink_basin"] = (
                    np.asarray(center, np.float32), float(yaw),
                    np.array([0.16, 0.24], np.float32),
                    F.COUNTER_H - 0.11,
                )
            elif name.startswith("stove"):
                self.regions["stove_top"] = (
                    np.asarray(center, np.float32), float(yaw),
                    np.array([0.2, 0.3], np.float32), F.COUNTER_H + 0.02,
                )
        self.articulated = {
            k: v for k, v in self.fixtures.items()
            if hasattr(v, "active_joints")
        }
        self._device_tables()
        return self

    def _device_tables(self):
        dev = self.env.device
        slots = self.counter_slots or [((0.0, 0.0), 0.0, 0.8)]
        self._slot_center = torch.as_tensor(np.array([c for c, _, _ in slots], np.float32), device=dev)
        self._slot_yaw = torch.as_tensor(np.array([y for _, y, _ in slots], np.float32), device=dev)
        self._slot_width = torch.as_tensor(np.array([w for _, _, w in slots], np.float32), device=dev)
        self._region_tables = {
            name: (torch.as_tensor(center, device=dev), float(yaw), torch.as_tensor(half, device=dev), float(z))
            for name, (center, yaw, half, z) in self.regions.items()
        }

    def counter_spawn_pose(self, rng, margin=0.1) -> torch.Tensor:
        """Per-env random (B, 3) positions on a random counter top. ``rng``
        is the env's ``BatchedRNG`` (or anything with its ``randint`` and
        ``uniform``)."""
        idx = rng.randint(0, len(self._slot_yaw)).long()
        u = rng.uniform(-1.0, 1.0, (2,))
        c, yaw, w = self._slot_center[idx], self._slot_yaw[idx], self._slot_width[idx]
        half = torch.stack([torch.full_like(w, F.COUNTER_D / 2 - margin), w / 2 - margin], -1)
        local = u * half
        cos, sin = torch.cos(yaw), torch.sin(yaw)
        dx = cos * local[:, 0] - sin * local[:, 1]
        dy = sin * local[:, 0] + cos * local[:, 1]
        xy = c + torch.stack([dx, dy], -1)
        return torch.cat([xy, torch.full_like(xy[:, :1], F.COUNTER_H)], -1)

    def region_spawn_pose(self, rng, region, margin=0.02) -> torch.Tensor:
        """Per-env random (B, 3) positions inside a named spawn region
        (``self.regions``: sink_basin, stove_top); a counter top where the
        layout lacks the region."""
        if region not in self._region_tables:
            return self.counter_spawn_pose(rng)
        center, yaw, half, z = self._region_tables[region]
        u = rng.uniform(-1.0, 1.0, (2,))
        local = u * (half - margin)
        cos, sin = float(np.cos(yaw)), float(np.sin(yaw))
        dx = cos * local[:, 0] - sin * local[:, 1]
        dy = sin * local[:, 0] + cos * local[:, 1]
        xy = center + torch.stack([dx, dy], -1)
        return torch.cat([xy, torch.full_like(xy[:, :1], z)], -1)

    def initialize(self, env_idx, init_config_idxs=None):
        # every fixture's doors and drawers shut (joints reset to 0 with the env)
        pass
