"""SceneBuilder base (counterpart of
maniskill_tpu/scene_builder/scene_builder.py)."""
from __future__ import annotations

from typing import TYPE_CHECKING, Any, List, Optional

import numpy as np

if TYPE_CHECKING:
    from ..envs.base_env import BaseEnv


class SceneBuilder:
    """Build-vs-initialize split: ``build`` constructs static scene content
    once per reconfigure; ``initialize`` sets poses/joints every episode."""

    robot_init_qpos_noise: float = 0.02
    build_configs: Optional[List[Any]] = None
    init_configs: Optional[List[Any]] = None
    # the agent's default spawn (x y z qw qx qy qz); a builder overrides it to
    # stand the robot in free floor space (SceneManipulationEnv reads it)
    robot_initial_pose = np.array([0.0, 0.0, 0.02, 1, 0, 0, 0])

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
