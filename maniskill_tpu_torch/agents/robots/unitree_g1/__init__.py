from .g1 import UnitreeG1Simplified
from .g1_full import UnitreeG1, UnitreeG1UpperBody, UnitreeG1UpperBodyRightArm, UnitreeG1UpperBodyWithHeadCamera
