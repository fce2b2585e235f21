"""Row gathers with the JAX package's index semantics.

``tempme_tpu/ops/gather.py`` turns small-table gathers into one-hot matmuls
for the TPU's matrix unit; on the GPU a gather is plain indexing. The index
semantics stay: a negative index wraps once (Python style), then indices are
clamped to ``[0, N-1]``, as jitted ``table[idx]`` does.
"""
from __future__ import annotations

import torch


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [N, D], idx [...] int -> [..., D]."""
    n = table.shape[0]
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return table[idx]
