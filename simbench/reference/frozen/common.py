# Frozen copy of maniskill_tpu_torch/utils/common.py (top_k_stable) at the benchmark's first version:
# the benchmark's plain reference. It imports nothing of the program and is
# never edited to follow it.
from typing import Tuple

import torch


def top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries along the last axis, ties resolved lower index
    first, as XLA's ``top_k`` does (``torch.topk`` leaves the tie order
    unspecified)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
