"""Wrappers (counterpart of maniskill_tpu/wrappers), over the gymnasium-free
base in ``wrappers/base.py``."""
from .base import ActionWrapper, ObservationWrapper, Wrapper
from .flatten import FlattenActionSpaceWrapper, FlattenObservationWrapper, FlattenRGBDObservationWrapper
from .gymnasium import CPUGymWrapper
from .frame_stack import FrameStack
from .action_repeat import ActionRepeatWrapper
from .record import RecordEpisode
from .cached_reset import CachedResetWrapper
from .visual_encoders import VisualEncoderWrapper
