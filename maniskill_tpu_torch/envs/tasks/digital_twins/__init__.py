"""Digital-twin (real2sim evaluation) tasks (counterpart of
maniskill_tpu/envs/tasks/digital_twins/)."""
from .base_env import BaseDigitalTwinEnv  # noqa: F401
from . import bridge_dataset_eval  # noqa: F401
from . import so100_arm  # noqa: F401
