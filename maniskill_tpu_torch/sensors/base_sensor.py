"""BaseSensor and BaseSensorConfig (counterpart of
maniskill_tpu/sensors/base_sensor.py)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class BaseSensorConfig:
    uid: str


class BaseSensor:
    def __init__(self, config: BaseSensorConfig):
        self.config = config

    def setup(self):
        pass

    def capture(self):
        raise NotImplementedError

    def get_obs(self, **kwargs):
        raise NotImplementedError

    def get_params(self):
        return {}
