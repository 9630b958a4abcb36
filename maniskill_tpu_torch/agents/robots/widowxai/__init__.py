from .widowxai import WidowXAI
from .widowxai_wristcam import WidowXAIWristCam
