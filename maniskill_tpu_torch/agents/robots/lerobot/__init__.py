from .manipulator import LeRobotRealAgent
