from .googlerobot import GoogleRobot
