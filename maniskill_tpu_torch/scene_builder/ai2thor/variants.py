"""AI2THOR scene-builder variants (counterpart of
maniskill_tpu/scene_builder/ai2thor/variants.py).

With the AI2THOR-Hab dataset under ``$MS_ASSET_DIR/scene_datasets/ai2thor``
(the habitat scene_instance.json schema), scenes build from its meshes
through the shared habitat loader (``scene_builder/habitat.py``); its
``.glb`` meshes do not load in either package, so such a build falls back,
with a warning, to the procedural rooms. Otherwise each variant draws
procedural room layouts in its spirit (iTHOR: a single furnished room;
ProcTHOR: 16 layouts; ArchitecTHOR: a larger room; RoboTHOR: denser
furniture), deterministic per build-config index.
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ...utils.assets import ASSET_DIR
from ..registration import register_scene_builder
from ..replicacad.scene_builder import ensure_ground, rest_qpos
from ..scene_builder import SceneBuilder

logger = logging.getLogger(__name__)

AI2THOR_DIR = Path(ASSET_DIR) / "scene_datasets" / "ai2thor"
_GLB_INDEX = None  # built on first use, shared across variants


class _ProceduralRoomsBuilder(SceneBuilder):
    builds_lighting = False
    robot_initial_pose = np.array([0.0, 0, 0.02, 1, 0, 0, 0])
    n_layouts = 4
    room_half = (3.0, 2.5)
    furniture_count = 4
    scene_dataset: Optional[str] = None  # the subdirectory in the habitat configs

    def __init__(self, env, robot_init_qpos_noise: float = 0.02):
        super().__init__(env, robot_init_qpos_noise)
        self.build_configs = list(range(self.n_layouts))
        self._dataset_configs: List[Path] = []
        if self.scene_dataset and AI2THOR_DIR.exists():
            from ..habitat import list_scene_instances

            cfg_dir = AI2THOR_DIR / "ai2thorhab-uncompressed" / "configs" / "scenes" / self.scene_dataset
            self._dataset_configs = list_scene_instances(cfg_dir)
            if self._dataset_configs:
                self.build_configs = list(range(len(self._dataset_configs)))
        self._movable: List = []  # (actor, (7,) pose on the host)

    def build(self, build_config_idxs: Optional[List[int]] = None):
        idx = (build_config_idxs or [0])[0]
        built = False
        if self._dataset_configs:
            try:
                self._build_from_dataset(self._dataset_configs[idx % len(self._dataset_configs)])
                built = True
            except Exception as e:
                logger.warning("AI2THOR dataset build failed (%s); procedural fallback", e)
        if not built:
            self._build_procedural(idx)
        # the props' poses on the device once (no host copy in a reset)
        self._rest = rest_qpos(self.env)
        self._poses = [(actor, torch.as_tensor(pose, device=self.env.device)) for actor, pose in self._movable]

    def _build_from_dataset(self, cfg_path: Path):
        from ..habitat import build_scene_instance, index_glbs

        global _GLB_INDEX
        if _GLB_INDEX is None:
            _GLB_INDEX = index_glbs(AI2THOR_DIR)
        built = build_scene_instance(self.scene, cfg_path, _GLB_INDEX, movable_out=self._movable)
        logger.info("AI2THOR scene %s: %d objects", cfg_path.stem, built)

    def _build_procedural(self, idx: int):
        rng = np.random.RandomState(1000 + idx)
        scene = self.scene
        ensure_ground(scene)
        W, D = self.room_half
        H, T = 1.2, 0.05

        def sbox(name, pos, half, color=(0.85, 0.83, 0.8, 1)):
            b = scene.create_actor_builder()
            b.add_box_collision(half_size=half)
            b.add_box_visual(half_size=half, color=color)
            b.set_initial_pose(np.array(list(pos) + [1, 0, 0, 0], np.float64))
            return b.build_static(name=name)

        sbox("wall_n", (0, D, H), (W, T, H))
        sbox("wall_s", (0, -D, H), (W, T, H))
        sbox("wall_e", (W, 0, H), (T, D, H))
        sbox("wall_w", (-W, 0, H), (T, D, H))
        wood = (0.54, 0.39, 0.27, 1)
        for i in range(self.furniture_count):
            x = rng.uniform(-W + 0.8, W - 0.8)
            y = rng.uniform(-D + 0.8, D - 0.8)
            if abs(x) < 0.7 and abs(y) < 0.7:
                x += np.sign(x or 1.0) * 1.0
            hx, hy = rng.uniform(0.25, 0.6, 2)
            hz = rng.uniform(0.2, 0.5)
            sbox(f"furniture_{i}", (x, y, hz), (hx, hy, hz), wood)
        # two manipulable props
        for i in range(2):
            b = scene.create_actor_builder()
            b.add_box_collision(half_size=[0.025] * 3)
            b.add_box_visual(half_size=[0.025] * 3, color=(0.9, 0.25, 0.2, 1))
            pos = [rng.uniform(-1.0, 1.0), rng.uniform(-1.0, 1.0), 0.025]
            b.set_initial_pose(np.array(pos + [1, 0, 0, 0], np.float64))
            self._movable.append((b.build(name=f"prop_{i}"), np.asarray(pos + [1, 0, 0, 0], np.float32)))

    def initialize(self, env_idx, init_config_idxs: Optional[List[int]] = None):
        for agent, qpos in self._rest:
            agent.reset(qpos)
        # as the reference: the props' poses are set, their velocities left
        # as the reset's clearing of every velocity made them
        for actor, pose in self._poses:
            actor.set_pose(pose)


@register_scene_builder("iTHOR")
class iTHORSceneBuilder(_ProceduralRoomsBuilder):
    scene_dataset = "iTHOR"


@register_scene_builder("ProcTHOR")
class ProcTHORSceneBuilder(_ProceduralRoomsBuilder):
    scene_dataset = "ProcTHOR"
    n_layouts = 16
    furniture_count = 6


@register_scene_builder("ArchitecTHOR")
class ArchitecTHORSceneBuilder(_ProceduralRoomsBuilder):
    scene_dataset = "ArchitecTHOR"
    room_half = (4.5, 3.5)
    furniture_count = 8


@register_scene_builder("RoboTHOR")
class RoboTHORSceneBuilder(_ProceduralRoomsBuilder):
    scene_dataset = "RoboTHOR"
    furniture_count = 10  # maze-like density
