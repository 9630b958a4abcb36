from .common import (
    build_box,
    build_colorful_cube,
    build_cube,
    build_cylinder,
    build_red_white_target,
    build_sphere,
    build_twocolor_peg,
)

__all__ = [
    "build_box", "build_colorful_cube", "build_cube", "build_cylinder", "build_red_white_target",
    "build_sphere", "build_twocolor_peg",
]
