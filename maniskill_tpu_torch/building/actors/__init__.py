from .common import build_box, build_cube, build_sphere

__all__ = ["build_box", "build_cube", "build_sphere"]
