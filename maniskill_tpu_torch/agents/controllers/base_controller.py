"""Controller base classes (counterpart of
maniskill_tpu/agents/controllers/base_controller.py).

Controller *state* (PD targets) lives in the physics ``Data``
(drive_target / drive_vel_target), so partial-reset masking comes from the
scene's masked writes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from ...structs.articulation import Articulation, ArticulationJoint
from ...utils import gym_utils


@dataclasses.dataclass
class ControllerConfig:
    joint_names: List[str] = None
    normalize_action: bool = True


class BaseController:
    """Drives a subset of an articulation's joints from flat actions."""

    def __init__(self, config, articulation: Articulation, scene):
        self.config = config
        self.articulation = articulation
        self.scene = scene
        self.joints: List[ArticulationJoint] = [
            articulation.joints_map[n] if n in articulation.joints_map
            else self._joint_by_any_name(articulation, n)
            for n in config.joint_names
        ]
        self.dof_adrs = torch.tensor([j.dof_adr for j in self.joints], dtype=torch.int64, device=scene.device)
        self.q_adrs = torch.tensor([j.q_adr for j in self.joints], dtype=torch.int64, device=scene.device)
        self._action_space = None
        self._initialize_action_space()

    @staticmethod
    def _joint_by_any_name(articulation: Articulation, name: str) -> ArticulationJoint:
        for j in articulation.joints:
            if j.name == name or j.name.endswith(":" + name):
                return j
        raise KeyError(
            f"joint {name!r} not found in {articulation.name}; "
            f"known: {list(articulation.joints_map)}"
        )

    @property
    def action_space(self):
        return self._action_space

    @property
    def single_action_space(self):
        return self._action_space

    @property
    def qpos(self) -> torch.Tensor:
        """(B, n) positions of the controlled joints."""
        return self.scene.data.qpos[:, self.q_adrs]

    @property
    def qvel(self) -> torch.Tensor:
        """(B, n) velocities of the controlled joints."""
        return self.scene.data.qvel[:, self.dof_adrs]

    def _initialize_action_space(self):
        raise NotImplementedError

    def _clip_and_scale_action(self, action: torch.Tensor, low: torch.Tensor,
                               high: torch.Tensor) -> torch.Tensor:
        """Map a normalized [-1, 1] action to [low, high] (tensors on the
        action's device)."""
        action = torch.clamp(action, -1.0, 1.0)
        return 0.5 * (high + low) + 0.5 * (high - low) * action

    # -- lifecycle -------------------------------------------------------
    def set_drive_property(self):
        """Write PD gains into the model (called once at controller setup)."""

    def reset(self):
        """Reset controller targets for envs selected by the scene reset mask."""

    def set_action(self, action: torch.Tensor):
        raise NotImplementedError

    def before_simulation_step(self, data, substep: int):
        """Per-substep hook; returns updated Data."""
        return data

    def get_state(self) -> Dict:
        return {}

    def set_state(self, state: Dict):
        pass


class DictController(BaseController):
    """Combines named sub-controllers into a dict action space."""

    def __init__(self, configs: Dict[str, object], articulation, scene, balance_passive_force=True):
        # ``balance_passive_force`` is taken for the JAX package's signature
        # and, as there, not read
        self.scene = scene
        self.articulation = articulation
        self.configs = configs
        self.controllers: Dict[str, BaseController] = {
            uid: cfg.controller_cls(cfg, articulation, scene) for uid, cfg in configs.items()
        }
        self._initialize_action_space()

    def _initialize_action_space(self):
        self._action_space = gym_utils.Dict(
            {uid: c.action_space for uid, c in self.controllers.items()}
        )

    def set_drive_property(self):
        for c in self.controllers.values():
            c.set_drive_property()

    def reset(self):
        for c in self.controllers.values():
            c.reset()

    def set_action(self, action: Dict):
        for uid, c in self.controllers.items():
            c.set_action(action[uid])

    def before_simulation_step(self, data, substep):
        for c in self.controllers.values():
            data = c.before_simulation_step(data, substep)
        return data

    def get_state(self):
        return {uid: c.get_state() for uid, c in self.controllers.items()}

    def set_state(self, state):
        for uid, c in self.controllers.items():
            c.set_state(state.get(uid, {}))


class CombinedController(DictController):
    """DictController with a single flat Box action space."""

    def _initialize_action_space(self):
        lows, highs = [], []
        self.action_mapping = {}
        start = 0
        for uid, c in self.controllers.items():
            n = c.action_space.shape[0]
            lows.append(c.action_space.low)
            highs.append(c.action_space.high)
            self.action_mapping[uid] = (start, start + n)
            start += n
        self._action_space = gym_utils.Box(np.concatenate(lows), np.concatenate(highs))

    def set_action(self, action: torch.Tensor):
        for uid, c in self.controllers.items():
            lo, hi = self.action_mapping[uid]
            c.set_action(action[..., lo:hi])

    def to_action_dict(self, action: torch.Tensor) -> Dict:
        """The flat action split into the sub-controllers' slices."""
        return {uid: action[..., lo:hi] for uid, (lo, hi) in self.action_mapping.items()}

    def from_action_dict(self, action_dict: Dict) -> torch.Tensor:
        return torch.cat([action_dict[uid] for uid in self.controllers], -1)
