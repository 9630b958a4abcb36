from .quadruped_reach import AnymalCReachEnv, QuadrupedReachEnv, UnitreeGo2ReachEnv
from .quadruped_spin import AnymalCSpinEnv, QuadrupedSpinEnv
