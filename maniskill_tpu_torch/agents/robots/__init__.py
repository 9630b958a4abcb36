"""Robots of the port; importing this package registers them."""
from .allegro_hand import AllegroHandLeft, AllegroHandRight, AllegroHandRightTouch
from .anymal import ANYmalC
from .dclaw import DClaw
from .fetch import Fetch
from .floating_ability_hand import FloatingAbilityHandRight
from .floating_panda_gripper import FloatingPandaGripper
from .inspire_hand import FixedInspireHandLeft, FixedInspireHandRight, FloatingInspireHandLeft, FloatingInspireHandRight
from .panda import Panda, PandaWristCam
from .trifingerpro import TriFingerPro
from .unitree_g1 import UnitreeG1Simplified
from .unitree_go import UnitreeGo2, UnitreeGo2Simplified
from .unitree_h1 import UnitreeH1, UnitreeH1Simplified
from .xarm import XArm7, XArm7Ability

__all__ = ["AllegroHandLeft", "AllegroHandRight", "AllegroHandRightTouch", "ANYmalC", "DClaw", "Fetch",
           "FixedInspireHandLeft", "FixedInspireHandRight", "FloatingAbilityHandRight", "FloatingInspireHandLeft",
           "FloatingInspireHandRight", "FloatingPandaGripper", "Panda", "PandaWristCam", "TriFingerPro",
           "UnitreeG1Simplified", "UnitreeGo2", "UnitreeGo2Simplified", "UnitreeH1", "UnitreeH1Simplified", "XArm7",
           "XArm7Ability"]
