from .base_sensor import BaseSensor, BaseSensorConfig
from .camera import Camera, CameraConfig
from .depth_camera import StereoDepthCamera, StereoDepthCameraConfig
