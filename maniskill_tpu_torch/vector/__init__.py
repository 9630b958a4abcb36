from .gymnasium import ManiSkillVectorEnv

__all__ = ["ManiSkillVectorEnv"]
