from .base_env import BaseBridgeEnv  # noqa: F401
from .put_on_in_scene import (  # noqa: F401
    PutCarrotOnPlateInScene,
    PutEggplantInBasketScene,
    PutSpoonOnTableClothInScene,
    StackGreenCubeOnYellowCubeBakedTexInScene,
)
