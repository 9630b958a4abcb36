"""Robots of the port; importing this package registers them."""
from .allegro_hand import AllegroHandLeft, AllegroHandRight, AllegroHandRightTouch
from .anymal import ANYmalC
from .dclaw import DClaw
from .fetch import Fetch
from .floating_ability_hand import FloatingAbilityHandRight
from .floating_panda_gripper import FloatingPandaGripper
from .floating_robotiq import FloatingRobotiq2F85Gripper
from .googlerobot import GoogleRobot
from .inspire_hand import FixedInspireHandLeft, FixedInspireHandRight, FloatingInspireHandLeft, FloatingInspireHandRight
from .koch import Koch
from .panda import Panda, PandaStick, PandaWristCam
from .so100 import SO100
from .stompy import Stompy
from .trifingerpro import TriFingerPro
from .unitree_g1 import (UnitreeG1, UnitreeG1Simplified, UnitreeG1UpperBody, UnitreeG1UpperBodyRightArm,
                         UnitreeG1UpperBodyWithHeadCamera)
from .unitree_go import UnitreeGo2, UnitreeGo2Simplified
from .unitree_h1 import UnitreeH1, UnitreeH1Simplified, UnitreeH1WithHandsUpperBodyOnly
from .ur_e import UR10e
from .widowx import WidowX250S, WidowX250SBridgeDatasetFlatTable, WidowX250SBridgeDatasetSink
from .widowxai import WidowXAI, WidowXAIWristCam
from .xarm import XArm7, XArm7Ability
from .xarm6 import XArm6NoGripper, XArm6NoGripperWristCamera, XArm6Robotiq, XArm6RobotiqWristCamera
from .xlerobot import Xlerobot

__all__ = [
    "AllegroHandLeft", "AllegroHandRight", "AllegroHandRightTouch", "ANYmalC", "DClaw", "Fetch",
    "FixedInspireHandLeft", "FixedInspireHandRight", "FloatingAbilityHandRight", "FloatingInspireHandLeft",
    "FloatingInspireHandRight", "FloatingPandaGripper", "FloatingRobotiq2F85Gripper", "GoogleRobot", "Koch",
    "Panda", "PandaStick", "PandaWristCam", "SO100", "Stompy", "TriFingerPro", "UnitreeG1", "UnitreeG1Simplified",
    "UnitreeG1UpperBody", "UnitreeG1UpperBodyRightArm", "UnitreeG1UpperBodyWithHeadCamera", "UnitreeGo2",
    "UnitreeGo2Simplified", "UnitreeH1", "UnitreeH1Simplified", "UnitreeH1WithHandsUpperBodyOnly", "UR10e",
    "WidowX250S", "WidowX250SBridgeDatasetFlatTable", "WidowX250SBridgeDatasetSink", "WidowXAI", "WidowXAIWristCam",
    "XArm6NoGripper", "XArm6NoGripperWristCamera", "XArm6Robotiq", "XArm6RobotiqWristCamera", "XArm7", "XArm7Ability",
    "Xlerobot",
]
