"""Asset registry (counterpart of maniskill_tpu/utils/assets/data.py).

The downloadable asset sources keyed by id, and the per-env
``DATA_GROUPS``. Envs check what is present and say how to fetch what is
missing: ``python -m maniskill_tpu_torch.utils.download_asset <uid>`` on a
machine with a network. ``ASSET_DIR`` is ``$MS_ASSET_DIR``, else
``~/.maniskill_tpu/data``, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Dict, List, Optional

ASSET_DIR = Path(
    os.environ.get("MS_ASSET_DIR", os.path.expanduser("~/.maniskill_tpu/data"))
)


@dataclasses.dataclass
class DataSource:
    source_type: str
    url: Optional[str] = None
    hf_repo_id: Optional[str] = None
    github_url: Optional[str] = None
    target_path: Optional[str] = None
    checksum: Optional[str] = None
    zip_dirname: Optional[str] = None
    filename: Optional[str] = None
    output_dir: Path = ASSET_DIR

    @property
    def path(self) -> Path:
        return self.output_dir / (self.target_path or "")

    def is_downloaded(self) -> bool:
        return self.path.exists()


DATA_SOURCES: Dict[str, DataSource] = {}
DATA_GROUPS: Dict[str, List[str]] = {}


def register_data_source(uid: str, **kwargs) -> DataSource:
    src = DataSource(**kwargs)
    DATA_SOURCES[uid] = src
    return src


# the registry's entries; tasks use real assets when downloaded and fall
# back to procedural stand-ins otherwise (e.g. building/actors/ycb.py)
register_data_source(
    "ycb", source_type="task_assets",
    url="https://huggingface.co/datasets/haosulab/ManiSkill2/resolve/main/data/mani_skill2_ycb.zip",
    target_path="assets/mani_skill2_ycb",
    checksum="1551724fd1ac7bad9807ebcf46dd4a788caed5c9499c1225b9bfa080ffbefcb3",
)
register_data_source(
    "pick_clutter_ycb_configs", source_type="task_assets",
    url="https://storage1.ucsd.edu/datasets/ManiSkill2022-assets/pick_clutter/ycb_train_5k.json.gz",
    target_path="tasks/pick_clutter",
    checksum="70ec176c7036f326ea7813b77f8c03bea9db5960198498957a49b2895a9ec338",
)
register_data_source(
    "assembling_kits", source_type="task_assets",
    url="https://storage1.ucsd.edu/datasets/ManiSkill2022-assets/assembling_kits_v1.zip",
    target_path="tasks/assembling_kits",
    checksum="e3371f17a07a012edaa3a0b3604fb1577f3fb921876c3d5ed59733dd75a6b4a0",
)
register_data_source(
    "panda_avoid_obstacles", source_type="task_assets",
    url="https://storage1.ucsd.edu/datasets/ManiSkill2022-assets/avoid_obstacles/panda_train_2k.json.gz",
    target_path="tasks/avoid_obstacles",
    checksum="44dae9a0804172515c290c1f49a1e7e72d76e40201a2c5c7d4a3ccd43b4d5be4",
)
register_data_source(
    "bridge_v2_real2sim", source_type="task_assets",
    url="https://huggingface.co/datasets/haosulab/ManiSkill_bridge_v2_real2sim/resolve/main/bridge_v2_real2sim_dataset.zip",
    target_path="tasks/bridge_v2_real2sim_dataset",
    checksum="618512a205b4528cafecdad14b1788ed1130879f3064deb406516ed5b9c5ba92",
)
register_data_source(
    "partnet_mobility_cabinet", source_type="objects",
    url="https://storage1.ucsd.edu/datasets/ManiSkill2022-assets/partnet_mobility/dataset/",
    target_path="partnet_mobility/dataset",
)

# per-model PartNet-Mobility sources, one per model zip, grouped per
# category, enumerated from the package's own train-split id lists
_PM_META = Path(__file__).resolve().parents[2] / "assets" / "partnet_mobility" / "meta"
_pm_category_uids: Dict[str, List[str]] = {}
for _cat in ["cabinet_drawer", "cabinet_door", "chair", "bucket", "faucet"]:
    _meta = _PM_META / f"info_{_cat}_train.json"
    _uids = []
    if _meta.exists():
        import json as _json

        for _mid in sorted(_json.loads(_meta.read_text()).keys()):
            _uid = f"partnet_mobility/{_mid}"
            if _uid not in DATA_SOURCES:
                register_data_source(
                    _uid, source_type="objects",
                    url=f"https://storage1.ucsd.edu/datasets/ManiSkill2022-assets/partnet_mobility/dataset/{_mid}.zip",
                    target_path=f"partnet_mobility/dataset/{_mid}",
                )
            _uids.append(_uid)
    _pm_category_uids[_cat] = _uids

DATA_GROUPS["partnet_mobility_cabinet_models"] = (
    _pm_category_uids["cabinet_drawer"] + _pm_category_uids["cabinet_door"]
)
DATA_GROUPS["partnet_mobility_chair"] = _pm_category_uids["chair"]
DATA_GROUPS["partnet_mobility_bucket"] = _pm_category_uids["bucket"]
DATA_GROUPS["partnet_mobility_faucet"] = _pm_category_uids["faucet"]
DATA_GROUPS["partnet_mobility"] = [
    u for c in _pm_category_uids.values() for u in c
]
# interactable scene datasets
register_data_source(
    "ReplicaCAD", source_type="scene",
    hf_repo_id="haosulab/ReplicaCAD",
    target_path="scene_datasets/replica_cad_dataset",
)
register_data_source(
    "ReplicaCADRearrange", source_type="scene",
    url="https://huggingface.co/datasets/haosulab/ReplicaCADRearrange/resolve/main/rearrange.zip",
    target_path="scene_datasets/replica_cad_dataset/rearrange",
)
register_data_source(
    "AI2THOR", source_type="scene",
    url="https://huggingface.co/datasets/haosulab/AI2THOR/resolve/main/ai2thor.zip",
    target_path="scene_datasets/ai2thor",
)
register_data_source(
    "RoboCasa", source_type="scene",
    url="https://huggingface.co/datasets/haosulab/RoboCasa/resolve/main/robocasa_dataset.zip",
    target_path="scene_datasets/robocasa_dataset",
)
# robot asset packs (our zoo ships compact in-package URDFs; these sources
# provide the full-mesh originals when downloaded)
for _uid, _url, _tp in [
    ("ur10e", "https://github.com/haosulab/ManiSkill-UR10e/archive/refs/tags/v0.1.0.zip", "robots/ur10e"),
    ("anymal_c", "https://github.com/haosulab/ManiSkill-ANYmalC/archive/refs/tags/v0.1.1.zip", "robots/anymal_c"),
    ("unitree_h1", "https://github.com/haosulab/ManiSkill-UnitreeH1/archive/refs/tags/v0.1.0.zip", "robots/unitree_h1"),
    ("unitree_g1", "https://github.com/haosulab/ManiSkill-UnitreeG1/archive/refs/tags/v0.1.0.zip", "robots/unitree_g1"),
    ("unitree_go2", "https://github.com/haosulab/ManiSkill-UnitreeGo2/archive/refs/tags/v0.1.1.zip", "robots/unitree_go2"),
    ("stompy", "https://github.com/haosulab/ManiSkill-Stompy/archive/refs/tags/v0.1.0.zip", "robots/stompy"),
    ("widowx250s", "https://github.com/haosulab/ManiSkill-WidowX250S/archive/refs/tags/v0.2.0.zip", "robots/widowx"),
    ("googlerobot", "https://github.com/haosulab/ManiSkill-GoogleRobot/archive/refs/tags/v0.1.0.zip", "robots/googlerobot"),
    ("robotiq_2f", "https://github.com/haosulab/ManiSkill-Robotiq_2F/archive/refs/tags/v0.1.0.zip", "robots/robotiq_2f"),
    ("xarm6", "https://github.com/haosulab/ManiSkill-XArm6/archive/refs/tags/v0.1.1.zip", "robots/xarm6"),
    ("widowxai", "https://github.com/TrossenRobotics/ManiSkill-WidowX_AI/archive/refs/tags/v0.1.0.zip", "robots/widowxai"),
    ("xlerobot", "https://github.com/Vector-Wangel/ManiSkill-XLeRobot/archive/refs/tags/v0.2.1.zip", "robots/xlerobot"),
]:
    register_data_source(_uid, source_type="robot", url=_url, target_path=_tp)
register_data_source(
    "oakink-v2", source_type="task_assets",
    url="https://huggingface.co/datasets/haosulab/OakInk-v2/resolve/main/object_repair.zip",
    target_path="tasks/oakink-v2",
)

DATA_GROUPS.update(
    {
        "PickSingleYCB-v1": ["ycb"],
        "PickClutterYCB-v1": ["ycb", "pick_clutter_ycb_configs"],
        "AssemblingKits-v1": ["assembling_kits"],
        "SceneManipulation-v1": ["ReplicaCAD"],
        "RoboCasaKitchen-v1": ["RoboCasa"],
    }
)


def expand_data_group_into_individual_data_source_ids(group: str) -> List[str]:
    """Recursively expand a group into data-source ids."""
    uids: List[str] = []

    def helper(uid: str):
        if uid in DATA_SOURCES:
            uids.append(uid)
        elif uid in DATA_GROUPS:
            for x in DATA_GROUPS[uid]:
                helper(x)

    for uid in DATA_GROUPS.get(group, []):
        helper(uid)
    return sorted(set(uids))


def is_data_group_downloaded(group: str) -> bool:
    return all(
        DATA_SOURCES[uid].is_downloaded()
        for uid in expand_data_group_into_individual_data_source_ids(group)
    )


def expected_assets_for_env(env_id: str) -> List[str]:
    return DATA_GROUPS.get(env_id, [])
