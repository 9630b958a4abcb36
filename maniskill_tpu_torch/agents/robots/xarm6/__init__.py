from .xarm6_nogripper import XArm6NoGripper
from .xarm6_robotiq import XArm6Robotiq
from .xarm6_wristcam import XArm6NoGripperWristCamera, XArm6RobotiqWristCamera
