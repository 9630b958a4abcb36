"""maniskill_tpu_torch: the PyTorch/CUDA port of maniskill_tpu.

It mirrors the JAX package's layout module by module (each module names its
counterpart) and runs on torch tensors: the batched physics, the env, agent
and controller layers, and camera sensors whose tiled rasterizer is two
hand-written CUDA kernels (csrc/raster_setup.cu, csrc/raster_tiles.cu) on
the card. It imports no
JAX. ``import maniskill_tpu_torch.envs`` registers the ported tasks.
"""
__version__ = "0.1.0"

import os

# the port's own copies of the robot descriptions it loads (URDFs under
# assets/robots/); it reads no file of the JAX package
PACKAGE_ASSET_DIR = os.path.join(os.path.dirname(__file__), "assets")

from .utils.logging_utils import logger  # noqa: F401  (the modules' loggers print through its handler)
from .utils.registration import REGISTERED_ENVS, make, register_env

__all__ = ["register_env", "make", "REGISTERED_ENVS", "__version__", "PACKAGE_ASSET_DIR"]
