from . import tabletop
from . import control
from . import benchmark
