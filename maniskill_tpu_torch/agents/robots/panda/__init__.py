from .panda import Panda
from .panda_wristcam import PandaWristCam
from .panda_stick import PandaStick
