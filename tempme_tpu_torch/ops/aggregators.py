"""TGAT's other neighbour aggregations: map attention, the LSTM pool and
the mean pool.

Port of ``tempme_tpu/ops/aggregators.py``. Each block takes the raw
per-level features of a parent and its n children, src [Bq, Df], src_t
[Bq, 1, Dt], seq [Bq, n, Df], seq_t [Bq, n, Dt], seq_e [Bq, n, De], the
padding mask [Bq, n] (True at padding), and returns ([Bq, Df], the
attention probabilities or None), the output merged with the parent's
features by TGAT's gated merge. Everything runs in float32 (the JAX
modules take no compute type) as plain PyTorch: the JAX package runs these
blocks in ``jnp``, not in a Pallas kernel.

* ``MapAttnLayer``: additive attention over [ngh || edge || time] keys,
  the query [src || 0 || src_t]. The reference's Linear(2 d_k -> 1) over
  concat(q, k) has no bias, so its score is ``q . w_q + k . w_k``, two
  small products and a broadcast add, with no concat built. The per-head
  width is ``d_model // n_head``, truncated (the prod path rounds up).
* ``LSTMPool``: an LSTM over the unmasked [ngh || edge || time] sequence
  from a zero carry; the last step's hidden state is merged (the padding
  mask is ignored, as in the reference). flax's cell layout: input
  kernels (i, f, g, o) without bias, hidden kernels with bias. It runs as
  an n-step loop of ``torch.lstm_cell`` (float32 GEMMs and PyTorch's fused
  cell kernel on the card), not as cuDNN's whole-sequence LSTM, which takes
  TF32 unless told otherwise and so would not agree with the CPU to
  float32 tolerances.
* ``MeanPool``: the unmasked mean of [ngh || edge] over the n slots.

Both pools raise on explain weights, as the JAX modules do (the
reference's pools take none). Fresh weights follow the JAX initialisers:
normal(sqrt(2 / (d_model + d_k))) for ``wq/wk/wv``, xavier-normal for
``weight_map_*``, ``fc`` and the merge, lecun-normal input kernels,
orthogonal recurrent kernels and zero biases in the LSTM cell.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from .attention import AttnDraws
from .layers import GatedMerge, _dropout, dense, lecun_normal_


class MapBasedTemporalAttention(nn.Module):
    """q [B, Nq, D], k [B, Nq*n, D] (the keys are the values too), mask
    [B, Nq*n] bool, explain_weight [B, Nq*n] -> (out [B, Nq, D], attn
    [B, Nq, h, n]). Each query attends to its own n keys. The scores are
    filled with -1e10 at the padding, then softmax, dropout (``draws.attn``
    [B, Nq, h, n]), the explain weight; after ``fc``, a leaky ReLU (0.2),
    dropout (``draws.fc`` [B, Nq, D]) and ``ln(out + q)``."""

    def __init__(self, n_head: int, d_model: int, d_k: int,
                 dropout: float = 0.0):
        super().__init__()
        self.n_head, self.d_k, self.dropout = n_head, d_k, dropout
        hd = n_head * d_k
        std = math.sqrt(2.0 / (d_model + d_k))

        def proj():
            return dense(d_model, hd, bias=False,
                         init=lambda w: nn.init.normal_(w, std=std))

        self.wq_node_transform = proj()
        self.wk_node_transform = proj()
        self.wv_node_transform = proj()
        self.weight_map_q = nn.Parameter(
            nn.init.xavier_normal_(torch.empty(1, d_k))[0])
        self.weight_map_k = nn.Parameter(
            nn.init.xavier_normal_(torch.empty(1, d_k))[0])
        self.fc = dense(hd, d_model, init=nn.init.xavier_normal_)
        self.ln = nn.LayerNorm(d_model, eps=1e-6)    # flax's default

    def forward(self, q, k, mask=None, explain_weight=None,
                draws: AttnDraws | None = None):
        b, nq, _ = q.shape
        n = k.shape[1] // nq
        h, dk = self.n_head, self.d_k
        qh = self.wq_node_transform(q).reshape(b, nq, h, dk)
        kh = self.wk_node_transform(k).reshape(b, nq, n, h, dk)
        vh = self.wv_node_transform(k).reshape(b, nq, n, h, dk)
        s_q = torch.einsum("bqhd,d->bqh", qh, self.weight_map_q)
        s_k = torch.einsum("bqnhd,d->bqhn", kh, self.weight_map_k)
        scores = s_q[..., None] + s_k                      # [B, Nq, h, n]
        if mask is not None:
            scores = scores.masked_fill(mask.reshape(b, nq, 1, n), -1e10)
        attn = torch.softmax(scores, dim=-1)
        attn = _dropout(attn, None if draws is None else draws.attn,
                        self.dropout)
        if explain_weight is not None:
            attn = attn * explain_weight.reshape(b, nq, 1, n)
        out = torch.einsum("bqhn,bqnhd->bqhd", attn, vh).reshape(b, nq,
                                                                 h * dk)
        out = F.leaky_relu(self.fc(out), negative_slope=0.2)
        out = _dropout(out, None if draws is None else draws.fc,
                       self.dropout)
        return self.ln(out + q), attn


class MapAttnLayer(nn.Module):
    """TGAT's block with ``attn_mode="map"``: q = [src || 0 || src_t],
    k = [seq || seq_e || seq_t], map attention, then the gated merge with
    the parent's raw features."""

    def __init__(self, feat_dim: int, edge_dim: int, time_dim: int,
                 n_head: int, dropout: float = 0.0):
        super().__init__()
        self.edge_dim = edge_dim
        d_model = feat_dim + edge_dim + time_dim
        self.map_attn = MapBasedTemporalAttention(
            n_head, d_model, max(d_model // n_head, 1), dropout)
        self.merger = GatedMerge(d_model, feat_dim, feat_dim, feat_dim)

    def forward(self, src, src_t, seq, seq_t, seq_e, mask=None,
                explain_weight=None, draws: AttnDraws | None = None):
        zero_e = src.new_zeros((src.shape[0], 1, self.edge_dim))
        q = torch.cat([src[:, None, :], zero_e, src_t], dim=-1)
        k = torch.cat([seq, seq_e, seq_t], dim=-1)
        out, attn = self.map_attn(q, k, mask=mask,
                                  explain_weight=explain_weight, draws=draws)
        return self.merger(out.squeeze(1), src), attn


class LSTMCell(nn.Module):
    """flax's ``OptimizedLSTMCell`` in PyTorch's stacked layout:
    ``weight_ih`` [4h, in] stacks the bias-free input kernels (ii, if, ig,
    io), ``weight_hh`` [4h, h] the hidden kernels (hi, hf, hg, ho),
    ``bias_hh`` [4h] their biases; gates i, f, g, o as ``torch.lstm_cell``
    orders them. The gates only see the sum of the two biases, so the
    parameter goes in as the input bias beside a zero hidden bias: the
    card's fused cell gives no bias gradient when its input bias is
    absent."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        h = hidden_size
        self.weight_ih = nn.Parameter(torch.empty(4 * h, input_size))
        self.weight_hh = nn.Parameter(torch.empty(4 * h, h))
        self.bias_hh = nn.Parameter(torch.zeros(4 * h))
        self.register_buffer("zero_bias", torch.zeros(4 * h),
                             persistent=False)
        with torch.no_grad():
            for i in range(4):
                lecun_normal_(self.weight_ih[i * h:(i + 1) * h])
                nn.init.orthogonal_(self.weight_hh[i * h:(i + 1) * h])

    def forward(self, seq):
        """seq [B, L, in] -> the last step's hidden state [B, h], from a
        zero carry."""
        b = seq.shape[0]
        hx = seq.new_zeros((b, self.weight_hh.shape[1]))
        cx = hx
        # unbind: one stack of the steps' gradients in the backward, where
        # a slice per step would add a zero-filled [B, L, in] per step
        for x_t in seq.unbind(dim=1):
            hx, cx = torch.lstm_cell(x_t, (hx, cx), self.weight_ih,
                                     self.weight_hh, self.bias_hh,
                                     self.zero_bias)
        return hx


class LSTMPool(nn.Module):
    """The LSTM over [seq || seq_e || seq_t], its last hidden state merged
    with the parent's features."""

    def __init__(self, feat_dim: int, edge_dim: int, time_dim: int):
        super().__init__()
        self.lstm = LSTMCell(feat_dim + edge_dim + time_dim, feat_dim)
        self.merger = GatedMerge(feat_dim, feat_dim, feat_dim, feat_dim)

    def forward(self, src, src_t, seq, seq_t, seq_e, mask=None,
                explain_weight=None, draws=None):
        if explain_weight is not None:
            raise ValueError("LSTMPool does not support explain weights")
        hn = self.lstm(torch.cat([seq, seq_e, seq_t], dim=-1))
        return self.merger(hn, src), None


class MeanPool(nn.Module):
    """The mean of [seq || seq_e] over the n slots, padding included,
    merged with the parent's features."""

    def __init__(self, feat_dim: int, edge_dim: int):
        super().__init__()
        self.merger = GatedMerge(feat_dim + edge_dim, feat_dim, feat_dim,
                                 feat_dim)

    def forward(self, src, src_t, seq, seq_t, seq_e, mask=None,
                explain_weight=None, draws=None):
        if explain_weight is not None:
            raise ValueError("MeanPool does not support explain weights")
        hn = torch.cat([seq, seq_e], dim=-1).mean(dim=1)
        return self.merger(hn, src), None
