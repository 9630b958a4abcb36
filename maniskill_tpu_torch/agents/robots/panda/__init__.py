from .panda import Panda
from .panda_wristcam import PandaWristCam
