"""Common batched helpers (counterpart of maniskill_tpu/utils/common.py)."""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch


def to_tensor(x: Any, device=None, dtype=None) -> torch.Tensor:
    """Array-like / nested numbers -> tensor on ``device`` (float64 -> float32
    unless ``dtype`` says otherwise)."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    if dtype is None and x.dtype == torch.float64:
        dtype = torch.float32
    return x.to(device=device if device is not None else x.device, dtype=dtype or x.dtype)


def flatten_state_dict(state_dict: Dict) -> torch.Tensor:
    """Flatten a nested dict of batched tensors into one (B, D) tensor
    (ordered, recursive, column concat)."""
    leaves = []

    def visit(d):
        for v in d.values():
            if isinstance(v, dict):
                visit(v)
                continue
            arr = to_tensor(v)
            if arr.ndim == 0:
                continue
            if arr.ndim == 1:
                arr = arr[:, None]
            elif arr.ndim > 2:
                arr = arr.reshape(arr.shape[0], -1)
            leaves.append(arr.to(torch.float32))

    visit(state_dict)
    if not leaves:
        return torch.zeros(0)
    return torch.cat(leaves, -1)


def compute_angle_between(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Batched angle between vectors over the last axis (radians)."""
    n1 = x1 / torch.clamp(torch.linalg.vector_norm(x1, dim=-1, keepdim=True), min=1e-9)
    n2 = x2 / torch.clamp(torch.linalg.vector_norm(x2, dim=-1, keepdim=True), min=1e-9)
    return torch.arccos(torch.clamp(torch.sum(n1 * n2, -1), -1.0, 1.0))


def top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries along the last axis, ties resolved lower index
    first, as XLA's ``top_k`` does (``torch.topk`` leaves the tie order
    unspecified)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
