"""Merge head (port of ``tempme_tpu/ops/layers.py`` ``ConcatMerge``)."""
from __future__ import annotations

import torch
from torch import nn


class ConcatMerge(nn.Module):
    """concat(x1, x2) -> fc1 -> relu -> fc2."""

    def __init__(self, in_dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden)
        self.fc2 = nn.Linear(hidden, out)

    def forward(self, x1, x2):
        return self.fc2(torch.relu(self.fc1(torch.cat([x1, x2], dim=-1))))
