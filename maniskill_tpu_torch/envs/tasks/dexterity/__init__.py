from .insert_flower import InsertFlowerEnv
from .rotate_cube import RotateCubeEnv
from .rotate_single_object_in_hand import RotateSingleObjectInHandLevel0
from .rotate_valve import RotateValveEnv
