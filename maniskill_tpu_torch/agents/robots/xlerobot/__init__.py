from .xlerobot import Xlerobot
