from .base_agent import BaseAgent, Keyframe
from .registration import REGISTERED_AGENTS, register_agent

__all__ = ["BaseAgent", "Keyframe", "REGISTERED_AGENTS", "register_agent"]
