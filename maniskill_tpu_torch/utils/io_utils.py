"""JSON helpers (counterpart of maniskill_tpu/utils/io_utils.py): an encoder
that writes numpy scalars and arrays, and torch tensors, as JSON numbers and
lists."""
from __future__ import annotations

import json

import numpy as np
import torch


class _NumpyEncoder(json.JSONEncoder):
    def default(self, o):
        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        if isinstance(o, np.bool_):
            return bool(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, torch.Tensor):
            return o.detach().cpu().tolist()
        return super().default(o)


def dump_json(path, obj, **kwargs):
    kwargs.setdefault("cls", _NumpyEncoder)
    kwargs.setdefault("indent", 2)
    with open(path, "w") as f:
        json.dump(obj, f, **kwargs)


def load_json(path):
    with open(path) as f:
        return json.load(f)
