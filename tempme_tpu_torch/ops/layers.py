"""Merge heads and the JAX package's initialisers.

Port of ``tempme_tpu/ops/layers.py`` ``ConcatMerge`` and ``GatedMerge``.
Layers start from the
distributions flax gives them (``tempme_tpu/ops/layers.py``,
``ops/attention.py``, flax ``Dense`` and ``GRUCell`` defaults), not from
``torch.nn``'s: ``Dense`` kernels are ``lecun_normal`` (a normal truncated
at two standard deviations, variance ``1 / fan_in``) with zero biases, the
merge layers and attention ``fc`` are ``xavier_normal`` with zero biases.
"""
from __future__ import annotations

import math

import torch
from torch import nn

# flax's truncated normal on [-2, 2] has this standard deviation; lecun_normal
# divides by it so that the truncated draws keep variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor) -> torch.Tensor:
    std = math.sqrt(1.0 / w.shape[1]) / _TRUNC_STD
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std)


def dense(d_in: int, d_out: int, bias: bool = True, init=lecun_normal_):
    """``nn.Linear`` started as a flax ``Dense``: ``init`` on the weight
    (``lecun_normal_`` by default), zero bias."""
    lin = nn.Linear(d_in, d_out, bias=bias)
    with torch.no_grad():
        init(lin.weight)
        if bias:
            lin.bias.zero_()
    return lin


class ConcatMerge(nn.Module):
    """concat(x1, x2) -> fc1 -> relu -> fc2."""

    def __init__(self, in_dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = dense(in_dim, hidden, init=nn.init.xavier_normal_)
        self.fc2 = dense(hidden, out, init=nn.init.xavier_normal_)

    def forward(self, x1, x2):
        return self.fc2(torch.relu(self.fc1(torch.cat([x1, x2], dim=-1))))


class GatedMerge(nn.Module):
    """TGAT's two-branch merge: fc22(relu(fc12(x2))) + fc21(relu(fc11(x1)))
    (times ``explain_weight`` on the first branch where given). x1 [..., d1],
    x2 [..., d2] -> [..., dim4]; the four kernels start ``xavier_normal``,
    the biases at zero."""

    def __init__(self, d1: int, d2: int, dim3: int, dim4: int):
        super().__init__()
        xavier = nn.init.xavier_normal_
        self.fc11 = dense(d1, dim3, init=xavier)
        self.fc21 = dense(dim3, dim4, init=xavier)
        self.fc12 = dense(d2, dim3, init=xavier)
        self.fc22 = dense(dim3, dim4, init=xavier)

    def forward(self, x1, x2, explain_weight=None):
        x21 = self.fc21(torch.relu(self.fc11(x1)))
        x22 = self.fc22(torch.relu(self.fc12(x2)))
        if explain_weight is not None:
            x21 = x21 * explain_weight[..., None]
        return x22 + x21
