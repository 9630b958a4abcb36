"""Scene-builder registry (counterpart of
maniskill_tpu/scene_builder/registration.py)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Type

from .scene_builder import SceneBuilder


@dataclasses.dataclass
class SceneBuilderSpec:
    scene_builder_cls: Type[SceneBuilder]


REGISTERED_SCENE_BUILDERS: Dict[str, SceneBuilderSpec] = {}


def register_scene_builder(uid: str):
    def wrap(cls):
        REGISTERED_SCENE_BUILDERS[uid] = SceneBuilderSpec(scene_builder_cls=cls)
        return cls

    return wrap
