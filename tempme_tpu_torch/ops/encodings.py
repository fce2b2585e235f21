"""Time encoding ``cos(t * w + b)`` (port of ``tempme_tpu/ops/encodings.py``
``TimeEncode``): the trainable form TGN and TGAT use, and GraphMixer's
frozen one."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


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
