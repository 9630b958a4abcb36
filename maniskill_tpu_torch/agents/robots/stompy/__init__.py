from .stompy import Stompy
