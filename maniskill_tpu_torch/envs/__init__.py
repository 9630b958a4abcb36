from ..agents import robots  # noqa: F401  (registers the robots)
from .base_env import BaseEnv
from . import tasks  # registers the ported task envs

__all__ = ["BaseEnv"]
