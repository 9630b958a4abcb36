from .panda import Panda
