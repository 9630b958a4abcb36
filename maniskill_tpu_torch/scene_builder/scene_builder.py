"""SceneBuilder base (counterpart of
maniskill_tpu/scene_builder/scene_builder.py)."""
from __future__ import annotations

from typing import TYPE_CHECKING, List, Optional

if TYPE_CHECKING:
    from ..envs.base_env import BaseEnv


class SceneBuilder:
    """Build-vs-initialize split: ``build`` constructs static scene content
    once per reconfigure; ``initialize`` sets poses/joints every episode."""

    def __init__(self, env: "BaseEnv", robot_init_qpos_noise: float = 0.02):
        self.env = env
        self.robot_init_qpos_noise = robot_init_qpos_noise

    @property
    def scene(self):
        return self.env.scene

    def build(self, build_config_idxs: Optional[List[int]] = None):
        raise NotImplementedError

    def initialize(self, env_idx, init_config_idxs: Optional[List[int]] = None):
        raise NotImplementedError
