"""Robots of the port; importing this package registers them."""
from .anymal import ANYmalC
from .fetch import Fetch
from .panda import Panda, PandaWristCam
from .unitree_g1 import UnitreeG1Simplified
from .unitree_go import UnitreeGo2, UnitreeGo2Simplified
from .unitree_h1 import UnitreeH1, UnitreeH1Simplified

__all__ = ["ANYmalC", "Fetch", "Panda", "PandaWristCam", "UnitreeG1Simplified", "UnitreeGo2", "UnitreeGo2Simplified",
           "UnitreeH1", "UnitreeH1Simplified"]
