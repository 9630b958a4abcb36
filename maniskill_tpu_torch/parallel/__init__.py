"""Trainers (counterpart of maniskill_tpu/parallel/)."""
from .train import PPOConfig, PPOTrainer, ShardedPPOTrainer, make_sharded_ppo_step

__all__ = ["PPOConfig", "PPOTrainer", "ShardedPPOTrainer", "make_sharded_ppo_step"]
