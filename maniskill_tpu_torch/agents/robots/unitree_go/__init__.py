from .unitree_go2 import UnitreeGo2, UnitreeGo2Simplified
