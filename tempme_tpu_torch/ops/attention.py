"""Split-projection 1-query x n-neighbour temporal attention.

Port of ``tempme_tpu/ops/attention.py`` ``SplitTemporalAttention`` and
``_attend``. The key and value projections are bias-free linears over
``[node || edge || time]``, so they split into per-part projections: node
and edge parts are projected by the caller (once per table or per level),
and only the time part is projected per position here. The attention core
(scores, mask, softmax, dropout, explain weight, value sum) is the
``attend`` kernel in its eval or training form (``ops/kernels/attend.py``).

Dropout runs where the caller passes draws (``AttnDraws``): on the
attention probabilities, inside the kernel, and after ``fc``, each keeping
where ``u >= rate`` and scaling by ``1 / (1 - rate)``, as the JAX module
does in training. Without draws, or at rate 0, the module is the eval form.

Parameter names follow the JAX package (``wq_node`` ... ``wv_time``, ``fc``,
``ln``) so ``utils/convert.py`` maps a flax tree one to one; the layers
start from the JAX package's initialisers.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from .kernels.attend import attend, attend_drop
from .layers import dense


class AttnDraws(NamedTuple):
    """Uniforms in [0, 1) for one attention call's two dropout sites."""
    attn: torch.Tensor   # [B * Nq, h, n]: on the probabilities
    fc: torch.Tensor     # [B, Nq, d_model]: after fc


def _attend(qh, kh, vh, mask, explain_weight, dk, u=None, rate=0.0):
    """qh [M, h, dk], kh/vh [M, n, h, dk], mask [M, n] bool or None,
    explain_weight [M, n] or None, u [M, h, n] or None -> (out [M, h*dk],
    attn [M, h, n])."""
    scale = 1.0 / math.sqrt(dk)
    if u is not None and rate > 0.0:
        out, attn = attend_drop(qh, kh, vh, mask, explain_weight, u, rate,
                                scale)
    else:
        out, attn = attend(qh, kh, vh, mask, explain_weight, scale)
    return out.reshape(out.shape[0], -1), attn


class SplitTemporalAttention(nn.Module):
    def __init__(self, n_head: int, d_model: int, d_k: int, d_node: int,
                 d_edge: int, d_time: int, dropout: float = 0.0):
        super().__init__()
        self.n_head, self.d_k, self.dropout = n_head, d_k, dropout
        hd = n_head * d_k
        std = math.sqrt(2.0 / (d_model + d_k))

        def proj(d_in):
            return dense(d_in, hd, bias=False,
                         init=lambda w: nn.init.normal_(w, std=std))

        self.wq_node = proj(d_node)
        self.wq_time = proj(d_time)
        self.wk_node = proj(d_node)
        self.wk_edge = proj(d_edge)
        self.wk_time = proj(d_time)
        self.wv_node = proj(d_node)
        self.wv_edge = proj(d_edge)
        self.wv_time = proj(d_time)
        self.fc = dense(hd, d_model, init=nn.init.xavier_normal_)
        self.ln = nn.LayerNorm(d_model, eps=1e-5)

    def project_node(self, x):
        """Node-part key/value projections: [..., Dn] -> two [..., h*dk]."""
        return self.wk_node(x), self.wv_node(x)

    def project_edge(self, x):
        return self.wk_edge(x), self.wv_edge(x)

    def forward(self, q_node, q_time, residual, k_nv, v_nv, k_ev, v_ev,
                ngh_time, mask=None, explain_weight=None,
                draws: AttnDraws | None = None):
        """q_node [B,Nq,Dn], q_time [B,Nq,Dt], residual [B,Nq,d_model];
        k_nv/v_nv [B,Nngh,h*dk]; k_ev/v_ev the same or None;
        ngh_time [B,Nngh,Dt]; mask [B,Nngh] bool; ``draws`` the dropout
        uniforms (training) or None (eval) -> (out [B,Nq,d_model],
        attn [B,Nq,h,n])."""
        b, nq, _ = q_node.shape
        n = k_nv.shape[1] // nq
        h, dk = self.n_head, self.d_k
        drop = draws is not None and self.dropout > 0.0
        q = self.wq_node(q_node) + self.wq_time(q_time)
        k = k_nv + self.wk_time(ngh_time)
        v = v_nv + self.wv_time(ngh_time)
        if k_ev is not None:
            k = k + k_ev
            v = v + v_ev
        m = b * nq
        out, attn = _attend(
            q.reshape(m, h, dk), k.reshape(m, n, h, dk),
            v.reshape(m, n, h, dk),
            None if mask is None else mask.reshape(m, n),
            None if explain_weight is None else explain_weight.reshape(m, n),
            dk, draws.attn if drop else None, self.dropout)
        out = self.fc(out.reshape(b, nq, h * dk))
        if drop:
            out = torch.where(draws.fc >= self.dropout,
                              out / (1.0 - self.dropout), 0.0)
        return self.ln(out + residual), attn.reshape(b, nq, h, n)
