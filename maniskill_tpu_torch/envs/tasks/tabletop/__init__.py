from .pick_cube import PickCubeEnv
from .push_cube import PushCubeEnv
