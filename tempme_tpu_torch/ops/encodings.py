"""Time encodings (port of ``tempme_tpu/ops/encodings.py``): ``TimeEncode``
``cos(t * w + b)``, the trainable form TGN and TGAT use and GraphMixer's
frozen one; TGAT's ``PosEncode`` (an embedding of each row's sort order)
and ``EmptyEncode`` (zeros), and ``make_time_encoder`` over TGAT's
``use_time`` values."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F


class TimeEncode(nn.Module):
    """Input [..., L] -> output [..., L, dim]. ``freq`` starts at
    1/10**linspace(0, 9, dim), ``phase`` at 0, as in the JAX package. With
    ``trainable=False`` (GraphMixer) both are fixed buffers outside the
    ``state_dict``: no gradient, no optimizer state, no checkpoint entry,
    as the JAX tree has none."""

    def __init__(self, dim: int, trainable: bool = True):
        super().__init__()
        freq = torch.from_numpy(
            (1.0 / 10 ** np.linspace(0, 9, dim)).astype(np.float32))
        phase = torch.zeros(dim)
        if trainable:
            self.freq = nn.Parameter(freq)
            self.phase = nn.Parameter(phase)
        else:
            self.register_buffer("freq", freq, persistent=False)
            self.register_buffer("phase", phase, persistent=False)

    def forward(self, ts: torch.Tensor) -> torch.Tensor:
        return torch.cos(ts[..., None] * self.freq + self.phase)


class PosEncode(nn.Module):
    """Embeds ``argsort(ts)`` of each row through a ``[seq_len, dim]``
    table started at normal(0.02): the sort order (indices, not ranks), as
    the reference's ``PosEncode`` embeds it. The sort is stable, as JAX's
    is, so tied time deltas (padded slots) keep their positions. Input
    [..., L] -> [..., L, dim]; L must not exceed ``seq_len``."""

    def __init__(self, dim: int, seq_len: int):
        super().__init__()
        self.pos_table = nn.Parameter(torch.randn(seq_len, dim) * 0.02)

    def forward(self, ts: torch.Tensor) -> torch.Tensor:
        length = ts.shape[-1]
        if length > self.pos_table.shape[0]:
            raise ValueError(f"PosEncode: sequence length {length} exceeds "
                             f"seq_len {self.pos_table.shape[0]}")
        # an embedding lookup: its backward sums each row's many uses in
        # parallel segments, where indexing's accumulates them one by one
        return F.embedding(torch.argsort(ts, dim=-1, stable=True),
                           self.pos_table)


class EmptyEncode(nn.Module):
    """Zeros [..., L, dim]: no temporal information at all."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, ts: torch.Tensor) -> torch.Tensor:
        return ts.new_zeros(ts.shape + (self.dim,), dtype=torch.float32)


def make_time_encoder(method: str, dim: int, seq_len: int = 64,
                      trainable: bool = True) -> nn.Module:
    """The encoder of TGAT's ``use_time`` flag: "time", "pos" or "empty"."""
    if method == "time":
        return TimeEncode(dim, trainable=trainable)
    if method == "pos":
        return PosEncode(dim, seq_len)
    if method == "empty":
        return EmptyEncode(dim)
    raise ValueError(f"unknown time encoding method: {method!r}")
