"""ReplicaCAD scene builder (counterpart of
maniskill_tpu/scene_builder/replicacad/scene_builder.py).

Two asset paths:
- With the ReplicaCAD dataset under ``$MS_ASSET_DIR/scene_datasets/
  replica_cad_dataset`` (``python -m maniskill_tpu_torch.utils.download_asset
  ReplicaCAD``): loads ``configs/scenes/*.json``, cooking each
  referenced mesh into hull colliders and a visual mesh. The mesh reader
  takes no ``.glb``, so this build raises in both packages and falls back,
  with a warning, to the procedural apartment.
- Without the dataset: a procedural apartment of the same scale (floor,
  walls, kitchen counter, dining table, sofa, shelf and three dynamic props).
"""
from __future__ import annotations

import json
import logging
import os
from typing import List, Optional

import numpy as np
import torch

from ...building.ground import build_ground
from ...utils.assets import ASSET_DIR
from ..registration import register_scene_builder
from ..scene_builder import SceneBuilder

logger = logging.getLogger(__name__)

REPLICA_DIR = ASSET_DIR / "scene_datasets" / "replica_cad_dataset"


def ensure_ground(scene):
    """The scene's ground, built unless a dataset build that failed already
    made it (the JAX package's fallback builds a second one there and raises
    on its duplicate name)."""
    ground = scene.actors.get("ground")
    return ground if ground is not None else build_ground(scene)


def rest_qpos(env) -> List:
    """Per agent: (agent, its rest keyframe's qpos on the device or None)."""
    out = []
    for agent in getattr(env.agent, "agents", [env.agent]):
        kf = agent.keyframes.get("rest")
        qpos = None
        if kf is not None and kf.qpos is not None:
            qpos = torch.as_tensor(np.asarray(kf.qpos, np.float32), device=env.device)
        out.append((agent, qpos))
    return out


@register_scene_builder("ReplicaCAD")
class ReplicaCADSceneBuilder(SceneBuilder):
    builds_lighting = False
    robot_initial_pose = np.array([-1.0, 0, 0.02, 1, 0, 0, 0])

    def __init__(self, env, robot_init_qpos_noise: float = 0.02):
        super().__init__(env, robot_init_qpos_noise)
        self.build_configs: Optional[List[str]] = None
        scenes_dir = REPLICA_DIR / "configs" / "scenes"
        if scenes_dir.exists():
            self.build_configs = sorted(f for f in os.listdir(scenes_dir) if f.endswith(".json"))
        self._movable: List = []  # (actor, (7,) pose on the host)

    def build(self, build_config_idxs: Optional[List[int]] = None):
        built = False
        if self.build_configs:
            try:
                self._build_from_dataset(self.build_configs[(build_config_idxs or [0])[0]])
                built = True
            except Exception as e:
                logger.warning("ReplicaCAD dataset build failed (%s); procedural fallback", e)
        if not built:
            self._build_procedural()
        self._after_build()

    def _build_from_dataset(self, config_name: str):
        from ...utils.geometry.mesh_io import decimate, load_mesh

        with open(REPLICA_DIR / "configs" / "scenes" / config_name) as f:
            cfg = json.load(f)
        scene = self.scene
        build_ground(scene)
        # the static stage; ReplicaCAD stages are y-up, rotated to z-up
        stage_name = cfg["stage_instance"]["template_name"].split("/")[-1]
        v, fcs = load_mesh(str(REPLICA_DIR / "stages" / f"{stage_name}.glb"))
        b = scene.create_actor_builder()
        b.add_multiple_convex_collisions_from_mesh(v, fcs, max_parts=16)
        vv, vf = decimate(v, fcs, 5000)
        b.add_visual_from_mesh(vv, vf, color=[0.8, 0.8, 0.75, 1])
        b.set_initial_pose([0, 0, 0, 0.7071068, 0.7071068, 0, 0])
        b.build_static(name="stage")
        for i, obj in enumerate(cfg.get("object_instances", [])[:40]):
            tname = obj["template_name"].split("/")[-1]
            glb = REPLICA_DIR / "objects" / f"{tname}.glb"
            if not glb.exists():
                continue
            ov, of = load_mesh(str(glb))
            ob = scene.create_actor_builder()
            ob.add_multiple_convex_collisions_from_mesh(ov, of, max_parts=4, color=[0.7, 0.65, 0.6, 1])
            t = obj.get("translation", [0, 0, 0])
            r = obj.get("rotation", [1, 0, 0, 0])
            pose = [t[0], -t[2], t[1]] + list(r)  # y-up -> z-up
            ob.set_initial_pose(np.asarray(pose, np.float64))
            name = f"obj_{i}_{tname}"
            if obj.get("motion_type", "STATIC").upper() == "DYNAMIC":
                self._movable.append((ob.build(name=name), np.asarray(pose, np.float32)))
            else:
                ob.build_static(name=name)

    def _build_procedural(self):
        scene = self.scene
        ensure_ground(scene)
        wall_c = (0.85, 0.83, 0.8, 1)
        wood = (0.54, 0.39, 0.27, 1)

        def sbox(name, pos, half, color=wall_c):
            b = scene.create_actor_builder()
            b.add_box_collision(half_size=half)
            b.add_box_visual(half_size=half, color=color)
            b.set_initial_pose(np.array(list(pos) + [1, 0, 0, 0], np.float64))
            return b.build_static(name=name)

        # 8 m x 6 m room
        W, D, H, T = 4.0, 3.0, 1.4, 0.06
        sbox("wall_n", (0, D, H), (W, T, H))
        sbox("wall_s", (0, -D, H), (W, T, H))
        sbox("wall_e", (W, 0, H), (T, D, H))
        sbox("wall_w", (-W, 0, H), (T, D, H))
        # the kitchen counter along the north wall
        sbox("counter", (1.5, D - 0.45, 0.45), (1.6, 0.4, 0.45), wood)
        # dining table, sofa and shelf
        sbox("table_top", (0.0, 0.0, 0.74), (0.7, 0.5, 0.02), wood)
        for i, (sx, sy) in enumerate([(-1, -1), (-1, 1), (1, -1), (1, 1)]):
            sbox(f"table_leg_{i}", (0.62 * sx, 0.42 * sy, 0.36), (0.04, 0.04, 0.36), wood)
        sbox("sofa_seat", (-2.5, -1.8, 0.25), (1.0, 0.45, 0.25), (0.35, 0.35, 0.5, 1))
        sbox("sofa_back", (-2.5, -2.2, 0.65), (1.0, 0.1, 0.25), (0.35, 0.35, 0.5, 1))
        sbox("shelf", (3.5, 1.5, 0.9), (0.25, 0.8, 0.9), wood)

        # dynamic props: graspable objects on the surfaces
        props = [
            ("prop_cube", (0.1, 0.1, 0.78), 0.025, (0.9, 0.2, 0.2, 1)),
            ("prop_cube2", (-0.3, -0.2, 0.78), 0.025, (0.2, 0.6, 0.9, 1)),
            ("prop_counter", (1.2, 2.35, 0.93), 0.03, (0.2, 0.8, 0.3, 1)),
        ]
        for name, pos, half, color in props:
            b = scene.create_actor_builder()
            b.add_box_collision(half_size=[half] * 3)
            b.add_box_visual(half_size=[half] * 3, color=color)
            b.set_initial_pose(np.array(list(pos) + [1, 0, 0, 0], np.float64))
            self._movable.append((b.build(name=name), np.asarray(list(pos) + [1, 0, 0, 0], np.float32)))

    def _after_build(self):
        """The rest qpos and the props' poses on the device once: a
        host-to-device copy in every reset would stall a rollout's masked
        resets."""
        dev = self.env.device
        self._rest = rest_qpos(self.env)
        self._poses = [(actor, torch.as_tensor(pose, device=dev)) for actor, pose in self._movable]
        self._zero_vel = torch.zeros(self.env.num_envs, 3, device=dev)

    def initialize(self, env_idx, init_config_idxs: Optional[List[int]] = None):
        for agent, qpos in self._rest:
            agent.reset(qpos)
        for actor, pose in self._poses:
            actor.set_pose(pose)
            actor.set_linear_velocity(self._zero_vel)
            actor.set_angular_velocity(self._zero_vel)
