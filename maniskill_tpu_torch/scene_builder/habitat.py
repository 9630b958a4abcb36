"""Loader of Habitat-format scene datasets (counterpart of
maniskill_tpu/scene_builder/habitat.py).

ReplicaCAD and AI2THOR-Hab ship ``*.scene_instance.json`` files in the
Habitat scene-dataset schema: a ``stage_instance`` (the static shell) and
``object_instances`` with template names, y-up translations and rotations,
and a motion type. ``build_scene_instance`` turns one such config into
actors: each referenced mesh is decomposed into hull proxies for collision
and decimated for its visual. The mesh reader takes ``.stl`` and ``.obj``
only, so a ``.glb`` raises in both packages and the builders fall back to
their procedural scenes.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

_Y_UP_TO_Z_UP = np.array([0.7071068, 0.7071068, 0.0, 0.0])


def index_glbs(root: Path) -> Dict[str, Path]:
    """glb basename (no extension) -> path, for template resolution."""
    idx: Dict[str, Path] = {}
    for p in root.rglob("*.glb"):
        idx.setdefault(p.stem, p)
    return idx


def _resolve(template_name: str, glb_index: Dict[str, Path]) -> Optional[Path]:
    stem = Path(template_name).stem
    # habitat configs often reference "<name>.object_config.json" templates
    for suffix in (".object_config", ".stage_config"):
        if stem.endswith(suffix):
            stem = stem[: -len(suffix)]
    return glb_index.get(stem)


def build_scene_instance(scene, cfg_path: Path, glb_index: Dict[str, Path], max_objects: int = 40,
                         movable_out: Optional[List] = None):
    """Build the stage and objects of one .scene_instance.json into
    ``scene``. Returns the number of objects built. Raises if the stage's
    mesh is missing or cannot be read (the callers fall back to their
    procedural scenes)."""
    from ..building.ground import build_ground
    from ..utils.geometry.mesh_io import decimate, load_mesh

    with open(cfg_path) as f:
        cfg = json.load(f)
    build_ground(scene)

    stage_t = cfg["stage_instance"]["template_name"]
    stage_glb = _resolve(stage_t, glb_index)
    if stage_glb is None:
        raise FileNotFoundError(f"stage glb for {stage_t!r} not found")
    v, fcs = load_mesh(str(stage_glb))
    b = scene.create_actor_builder()
    b.add_multiple_convex_collisions_from_mesh(v, fcs, max_parts=16)
    vv, vf = decimate(v, fcs, 5000)
    b.add_visual_from_mesh(vv, vf, color=[0.8, 0.8, 0.75, 1])
    b.set_initial_pose(np.concatenate([[0, 0, 0], _Y_UP_TO_Z_UP]))
    b.build_static(name="stage")

    built = 0
    for i, obj in enumerate(cfg.get("object_instances", [])):
        if built >= max_objects:
            break
        glb = _resolve(obj["template_name"], glb_index)
        if glb is None:
            continue
        ov, of = load_mesh(str(glb))
        ob = scene.create_actor_builder()
        ob.add_multiple_convex_collisions_from_mesh(ov, of, max_parts=4, color=[0.7, 0.65, 0.6, 1])
        t = obj.get("translation", [0, 0, 0])
        r = obj.get("rotation", [1, 0, 0, 0])
        raw = np.asarray([t[0], -t[2], t[1]] + list(r), np.float64)  # y-up -> z-up
        ob.set_initial_pose(raw)
        name = f"obj_{i}_{Path(obj['template_name']).stem}"
        if obj.get("motion_type", "STATIC").upper() == "DYNAMIC":
            actor = ob.build(name=name)
            if movable_out is not None:
                movable_out.append((actor, raw.astype(np.float32)))
        else:
            ob.build_static(name=name)
        built += 1
    return built


def list_scene_instances(configs_dir: Path) -> List[Path]:
    if not configs_dir.exists():
        return []
    return sorted(p for p in configs_dir.rglob("*.json")
                  if p.name.endswith("scene_instance.json") or "scene" in p.parent.name)
