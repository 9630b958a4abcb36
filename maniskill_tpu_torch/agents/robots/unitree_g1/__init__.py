from .g1 import UnitreeG1Simplified
