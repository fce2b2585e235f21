"""Merge heads, GraphMixer's feed-forward and mixer block, and the JAX
package's initialisers.

Port of ``tempme_tpu/ops/layers.py`` (``ConcatMerge``, ``GatedMerge``,
``FeedForward``, ``MixerBlock``). Layers start from the
distributions flax gives them (``tempme_tpu/ops/layers.py``,
``ops/attention.py``, flax ``Dense`` and ``GRUCell`` defaults), not from
``torch.nn``'s: ``Dense`` kernels are ``lecun_normal`` (a normal truncated
at two standard deviations, variance ``1 / fan_in``) with zero biases, the
merge layers and attention ``fc`` are ``xavier_normal`` with zero biases.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

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


class MixerDraws(NamedTuple):
    """Uniforms in [0, 1) for one ``MixerBlock``'s four dropout sites: a
    site keeps where ``u >= rate`` and scales by ``1 / (1 - rate)``."""
    token_hidden: torch.Tensor     # [B, C, int(token_expansion * n)]
    token_out: torch.Tensor        # [B, C, n]
    channel_hidden: torch.Tensor   # [B, n, int(channel_expansion * C)]
    channel_out: torch.Tensor      # [B, n, C]


def _dropout(x, u, rate: float):
    if u is None or rate <= 0.0:
        return x
    return torch.where(u >= rate, x / (1.0 - rate), 0.0)


class FeedForward(nn.Module):
    """Dense -> exact GELU -> dropout -> Dense -> dropout over the last axis
    of width ``dim``, the hidden width ``int(expansion * dim)``."""

    def __init__(self, dim: int, expansion: float, dropout: float = 0.0):
        super().__init__()
        self.hidden = int(expansion * dim)
        self.dropout = dropout
        self.fc1 = dense(dim, self.hidden)
        self.fc2 = dense(self.hidden, dim)

    def forward(self, x, u_hidden=None, u_out=None):
        h = nn.functional.gelu(self.fc1(x), approximate="none")
        h = self.fc2(_dropout(h, u_hidden, self.dropout))
        return _dropout(h, u_out, self.dropout)


class MixerBlock(nn.Module):
    """MLP-mixer block over x [B, tokens, channels]: the token mix (a
    LayerNorm and the token FFN across the tokens of each channel), a
    residual, the channel mix (a LayerNorm and the channel FFN), a residual.
    ``explain_weights`` [B, tokens] gate the input, the token mix's output
    and the channel mix's output; ``draws`` (a ``MixerDraws``, training) or
    None (eval)."""

    def __init__(self, num_tokens: int, num_channels: int,
                 token_expansion: float = 0.5, channel_expansion: float = 4.0,
                 dropout: float = 0.0):
        super().__init__()
        self.token_norm = nn.LayerNorm(num_tokens, eps=1e-5)
        self.token_ffn = FeedForward(num_tokens, token_expansion, dropout)
        self.channel_norm = nn.LayerNorm(num_channels, eps=1e-5)
        self.channel_ffn = FeedForward(num_channels, channel_expansion,
                                       dropout)

    def forward(self, x, explain_weights: Optional[torch.Tensor] = None,
                draws: Optional[MixerDraws] = None):
        ew = None if explain_weights is None else explain_weights[..., None]
        if ew is not None:
            x = x * ew
        d = draws or MixerDraws(None, None, None, None)
        h = self.token_ffn(self.token_norm(x.transpose(1, 2)),
                           d.token_hidden, d.token_out).transpose(1, 2)
        if ew is not None:
            h = h * ew
        x = h + x
        h = self.channel_ffn(self.channel_norm(x), d.channel_hidden,
                             d.channel_out)
        if ew is not None:
            h = h * ew
        return h + x
