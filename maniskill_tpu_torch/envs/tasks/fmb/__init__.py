from .fmb import FMBAssembly1Env
