from .so100 import SO100
