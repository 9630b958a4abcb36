from .lift_peg_upright import LiftPegUprightEnv
from .pick_cube import PickCubeEnv
from .place_sphere import PlaceSphereEnv
from .pull_cube import PullCubeEnv
from .pull_cube_tool import PullCubeToolEnv
from .push_cube import PushCubeEnv
from .stack_cube import StackCubeEnv
from .stack_pyramid import StackPyramidEnv
