"""PartNet-Mobility URDF ingestion (counterpart of
maniskill_tpu/building/articulations/partnet_mobility.py).

Loads PartNet-Mobility dataset URDFs (``mobility_cvx.urdf``,
``mobility_fixed.urdf`` or ``mobility.urdf`` under
``$MS_ASSET_DIR/partnet_mobility/dataset/<id>/``) through the URDF loader
with multi-hull convex cooking, applying the per-model metric ``scale`` of
the dataset's meta JSONs (``partnet_mobility/meta/info_*.json``). The result
is the same flat articulation every other builder makes, so real cabinets
flow through the per-env pipeline of the procedural ones.

``MS_ASSET_DIR`` is read on every call, so a caller (a test pointing at
tests/fixtures/partnet_mobility) can set it after import.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

_CACHE: Optional[dict] = None


def _asset_dir() -> Path:
    from ...utils.assets import ASSET_DIR

    # read anew on each call: ``utils.assets`` reads it once, at import
    return Path(os.environ.get("MS_ASSET_DIR", str(ASSET_DIR)))


def load_partnet_mobility_dataset(refresh: bool = False) -> dict:
    """Index the local PartNet-Mobility dataset: model meta + urdf paths."""
    global _CACHE
    if _CACHE is not None and not refresh:
        return _CACHE
    root = _asset_dir() / "partnet_mobility"
    model_data: Dict[str, dict] = {}
    meta_dir = root / "meta"
    if meta_dir.is_dir():
        for f in sorted(meta_dir.glob("info_*.json")):
            try:
                model_data.update(json.loads(f.read_text()))
            except (OSError, ValueError):
                continue
    urdf_paths: Dict[str, Path] = {}
    dataset = root / "dataset"
    if dataset.is_dir():
        ids = set(model_data) | {p.name for p in dataset.iterdir() if p.is_dir()}
        for mid in ids:
            mdir = dataset / str(mid)
            for name in ("mobility_cvx.urdf", "mobility_fixed.urdf", "mobility.urdf"):
                if (mdir / name).exists():
                    urdf_paths[str(mid)] = mdir / name
                    break
    _CACHE = dict(model_data=model_data, model_urdf_paths=urdf_paths)
    return _CACHE


def partnet_mobility_available() -> bool:
    return bool(load_partnet_mobility_dataset(refresh=True)["model_urdf_paths"])


def available_model_ids(kind: Optional[str] = None) -> List[str]:
    """Model ids with a local URDF; ``kind`` filters by meta (e.g. drawers)."""
    ds = load_partnet_mobility_dataset()
    ids = sorted(ds["model_urdf_paths"])
    if kind:
        ids = [
            i
            for i in ids
            if kind in str(ds["model_data"].get(i, {}).get("kind", kind))
        ]
    return ids


def get_partnet_mobility_builder(
    scene,
    id: str,
    fix_root_link: bool = True,
    urdf_config: Optional[dict] = None,
):
    """URDF -> (ArticulationBuilder, meta) for a PartNet-Mobility model."""
    from ..urdf_loader import URDFLoader

    ds = load_partnet_mobility_dataset()
    if str(id) not in ds["model_urdf_paths"]:
        raise FileNotFoundError(
            f"PartNet-Mobility model {id} not found under "
            f"{_asset_dir() / 'partnet_mobility/dataset'}; download it with "
            "python -m maniskill_tpu_torch.utils.download_asset partnet_mobility_cabinet, or point "
            "MS_ASSET_DIR at a directory whose partnet_mobility/dataset/<id>/ holds the model's URDF"
        )
    meta = ds["model_data"].get(str(id), {})
    loader = URDFLoader(scene)
    loader.fix_root_link = fix_root_link
    loader.scale = float(meta.get("scale", 1.0))
    loader.load_multiple_collisions_from_file = True
    loader.name = f"partnet-{id}"
    result = loader.parse(str(ds["model_urdf_paths"][str(id)]))
    builder = result["articulation_builders"][0]
    return builder, meta
