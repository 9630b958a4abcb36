"""Robots of the port; importing this package registers them."""
from .panda import Panda

__all__ = ["Panda"]
