"""Time encoding ``cos(t * w + b)`` (port of ``tempme_tpu/ops/encodings.py``
``TimeEncode``, the trainable form TGN uses)."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


class TimeEncode(nn.Module):
    """Input [..., L] -> output [..., L, dim]. ``freq`` starts at
    1/10**linspace(0, 9, dim), ``phase`` at 0, as in the JAX package."""

    def __init__(self, dim: int):
        super().__init__()
        freq = (1.0 / 10 ** np.linspace(0, 9, dim)).astype(np.float32)
        self.freq = nn.Parameter(torch.from_numpy(freq))
        self.phase = nn.Parameter(torch.zeros(dim))

    def forward(self, ts: torch.Tensor) -> torch.Tensor:
        return torch.cos(ts[..., None] * self.freq + self.phase)
