"""Row gathers with the JAX package's index semantics.

``tempme_tpu/ops/gather.py`` turns small-table gathers into one-hot matmuls
for the TPU's matrix unit; on the GPU a gather is plain indexing. The index
semantics stay: a negative index wraps once (Python style), then indices are
clamped to ``[0, N-1]``, as jitted ``table[idx]`` does.

The gather is ``F.embedding``, not ``table[idx]``: the two forwards are the
same row copy, but their backwards differ. Indexing's backward
(``index_put_`` with accumulation) handles repeated indices one index at a
time, and the TGN's supports repeat popular nodes thousands of times (the
wikipedia-shaped stream's items are Zipf-distributed): on the H100 those
backwards took 87 of a train step's 113 ms of device time (``PERF.md``).
``embedding``'s backward sorts the indices and sums each run of equal ones
in parallel segments.
"""
from __future__ import annotations

import torch


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [N, D], idx [...] int -> [..., D]."""
    n = table.shape[0]
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return torch.nn.functional.embedding(idx.long(), table)
