"""Prebuilt articulated assets (counterpart of
maniskill_tpu/building/articulations/)."""
from .cabinet import (  # noqa: F401
    CABINET_VARIANTS,
    CabinetInstance,
    build_cabinet_template,
    sample_cabinet_variants,
)
