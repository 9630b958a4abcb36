from .ur_10e import UR10e
