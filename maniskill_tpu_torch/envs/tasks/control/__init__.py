from .cartpole import CartpoleBalanceEnv, CartpoleSwingUpEnv
from .hopper import HopperStandEnv, HopperHopEnv
from .ant import AntWalkEnv, AntRunEnv
from .humanoid import (
    HumanoidRun, HumanoidRunHard, HumanoidStand, HumanoidStandHard, HumanoidWalk, HumanoidWalkHard,
)
