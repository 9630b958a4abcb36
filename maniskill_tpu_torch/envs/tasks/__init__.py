from . import tabletop
from . import control
from . import benchmark
from . import quadruped
from . import humanoid
from . import mobile_manipulation
from . import dexterity
from . import empty_env
