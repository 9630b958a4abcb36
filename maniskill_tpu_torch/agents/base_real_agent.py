"""BaseRealAgent (counterpart of maniskill_tpu/agents/base_real_agent.py).

The interface of a real robot that mirrors a sim agent's action and obs
contract. Users subclass it and implement the hardware I/O, which stays
numpy on the host; ``Sim2RealEnv`` drives it and puts what it reads on the
sim env's device.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class BaseRealAgent:
    """Abstract driver for a physical robot paired with a sim agent uid."""

    uid: str = "base_real_agent"

    def __init__(self):
        self._sensors = {}

    # -- lifecycle -------------------------------------------------------
    def start(self):
        """Connect to the hardware."""
        raise NotImplementedError

    def stop(self):
        """Disconnect and power down."""
        raise NotImplementedError

    def reset(self, qpos: Optional[np.ndarray] = None):
        """Move the robot to the given joint configuration (blocking)."""
        raise NotImplementedError

    # -- control ---------------------------------------------------------
    def set_target_qpos(self, qpos: np.ndarray):
        raise NotImplementedError

    def set_target_qvel(self, qvel: np.ndarray):
        raise NotImplementedError

    # -- state -----------------------------------------------------------
    def get_qpos(self) -> np.ndarray:
        """(dof,) joint positions in radians."""
        raise NotImplementedError

    def get_qvel(self) -> np.ndarray:
        """(dof,) joint velocities; a robot that reports none raises
        ``NotImplementedError`` (``Sim2RealEnv`` then reads the synced sim)."""
        raise NotImplementedError

    def get_sensor_data(self) -> Dict[str, Dict[str, np.ndarray]]:
        """{sensor_name: {"rgb": (H, W, 3) uint8, ...}}."""
        raise NotImplementedError

    def get_proprioception(self) -> Dict[str, np.ndarray]:
        return dict(qpos=self.get_qpos(), qvel=self.get_qvel())
