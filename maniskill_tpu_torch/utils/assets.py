"""Where downloaded assets live (counterpart of
maniskill_tpu/utils/assets/data.py's ``ASSET_DIR``): ``$MS_ASSET_DIR``, else
``~/.maniskill_tpu/data``, as in the JAX package."""
from __future__ import annotations

import os
from pathlib import Path

ASSET_DIR = Path(os.environ.get("MS_ASSET_DIR", os.path.expanduser("~/.maniskill_tpu/data")))
