"""Package logger (counterpart of maniskill_tpu/utils/logging_utils.py).

The modules' own ``logging.getLogger(__name__)`` loggers (the URDF and MJCF
loaders, the scene builders) are children of this one, so its one handler
prints all of them.
"""
import logging

logger = logging.getLogger("maniskill_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(name)s] %(levelname)s: %(message)s"))
    logger.addHandler(_h)
logger.setLevel(logging.INFO)
