from .pick_cube import PickCubeEnv
