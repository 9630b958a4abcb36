"""Common batched helpers (counterpart of maniskill_tpu/utils/common.py)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch


def to_tensor(x: Any, dtype=None, device=None) -> torch.Tensor:
    """Array-like / nested numbers -> tensor on ``device`` (float64 -> float32
    unless ``dtype`` says otherwise)."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    if dtype is None and x.dtype == torch.float64:
        dtype = torch.float32
    return x.to(device=device if device is not None else x.device, dtype=dtype or x.dtype)


def to_numpy(x: Any) -> Any:
    """Tensors (in nested dicts, lists and tuples) as numpy arrays on the host."""
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_numpy(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def batch(x: Any) -> Any:
    """A leading batch axis of 1 on array-likes (in nested dicts)."""
    if isinstance(x, dict):
        return {k: batch(v) for k, v in x.items()}
    return to_tensor(x)[None]


def unbatch(x: Any) -> Any:
    """The leading batch axis of size 1 removed (in nested dicts, lists and
    tuples); other values as they are."""
    if isinstance(x, dict):
        return {k: unbatch(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(unbatch(v) for v in x)
    if isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim > 0 and x.shape[0] == 1:
        return x[0]
    return x


def flatten_state_dict(state_dict: Dict, use_jax: bool = True) -> torch.Tensor:
    """Flatten a nested dict of batched tensors into one (B, D) tensor
    (ordered, recursive, column concat). ``use_jax`` is taken for the JAX
    package's signature and, as there, not read."""
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


def flatten_dict_keys(d: Dict, prefix: str = "") -> Dict:
    """A nested dict as one level, keys joined with "/"."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(flatten_dict_keys(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def append_dict_array(x1, x2):
    """Nested dicts of arrays concatenated leaf by leaf along axis 0 (numpy)."""
    if isinstance(x1, dict):
        return {k: append_dict_array(x1[k], x2[k]) for k in x1}
    return np.concatenate([np.asarray(to_numpy(x1)), np.asarray(to_numpy(x2))], axis=0)


def index_dict_array(x, idx):
    """Every leaf of a nested dict indexed by ``idx``."""
    if isinstance(x, dict):
        return {k: index_dict_array(v, idx) for k, v in x.items()}
    return x[idx]


def compute_angle_between(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Batched angle between vectors over the last axis (radians)."""
    n1 = x1 / torch.clamp(torch.linalg.vector_norm(x1, dim=-1, keepdim=True), min=1e-9)
    n2 = x2 / torch.clamp(torch.linalg.vector_norm(x2, dim=-1, keepdim=True), min=1e-9)
    return torch.arccos(torch.clamp(torch.sum(n1 * n2, -1), -1.0, 1.0))


def tree_replace_masked(old, new, mask: torch.Tensor):
    """``new`` where ``mask`` (B,) holds and ``old`` elsewhere, leaf by leaf
    over nested dicts, lists, tuples and dataclasses of tensors (``Data``,
    ``Contact``); the mask broadcasts over each leaf's trailing axes. No
    value is read back to the host."""
    if isinstance(new, dict):
        return {k: tree_replace_masked(old[k], v, mask) for k, v in new.items()}
    if isinstance(new, (list, tuple)):
        vals = [tree_replace_masked(o, n, mask) for o, n in zip(old, new)]
        return type(new)(*vals) if hasattr(new, "_fields") else type(new)(vals)
    if dataclasses.is_dataclass(new):
        return dataclasses.replace(new, **{f.name: tree_replace_masked(getattr(old, f.name), getattr(new, f.name), mask)
                                           for f in dataclasses.fields(new)})
    if not isinstance(new, torch.Tensor):  # None, static fields
        return new
    m = mask.reshape(mask.shape + (1,) * (new.ndim - 1))
    return torch.where(m, new, old)


def top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries along the last axis, ties resolved lower index
    first, as XLA's ``top_k`` does (``torch.topk`` leaves the tie order
    unspecified)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
