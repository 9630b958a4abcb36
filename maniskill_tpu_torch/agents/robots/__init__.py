"""Robots of the port; importing this package registers them."""
from .panda import Panda, PandaWristCam

__all__ = ["Panda", "PandaWristCam"]
