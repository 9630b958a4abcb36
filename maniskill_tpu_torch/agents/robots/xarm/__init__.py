from .xarm7 import XArm7
from .xarm7_ability import XArm7Ability
