"""Nested-dict tree helpers (counterpart of maniskill_tpu/utils/tree.py)."""
from __future__ import annotations

from typing import Any, Dict

import torch


def replace(tree: Dict, new_tree: Dict, mask) -> Dict:
    """Masked recursive replace: ``new_tree`` where ``mask`` (B,) holds, else
    ``tree``; the mask broadcasts over each leaf's trailing axes."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = replace(v, new_tree[k], mask)
        else:
            m = torch.as_tensor(mask, device=v.device)
            m = m.reshape(m.shape + (1,) * (v.ndim - 1))
            out[k] = torch.where(m, new_tree[k], v)
    return out


def map_structure(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: map_structure(fn, v) for k, v in tree.items()}
    return fn(tree)
