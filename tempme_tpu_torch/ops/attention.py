"""Split-projection 1-query x n-neighbour temporal attention (eval form).

Port of ``tempme_tpu/ops/attention.py`` ``SplitTemporalAttention`` and
``_attend``. The key and value projections are bias-free linears over
``[node || edge || time]``, so they split into per-part projections: node
and edge parts are projected by the caller (once per table or per level),
and only the time part is projected per position here. The attention core
(scores, mask, softmax, explain weight, value sum) is the ``attend`` kernel
(``ops/kernels/attend.py``).

Parameter names follow the JAX package (``wq_node`` ... ``wv_time``, ``fc``,
``ln``) so ``utils/convert.py`` maps a flax tree one to one. This slice has
no dropout: the port serves, it does not train yet.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .kernels.attend import attend


def _attend(qh, kh, vh, mask, explain_weight, dk):
    """qh [M, h, dk], kh/vh [M, n, h, dk], mask [M, n] bool or None,
    explain_weight [M, n] or None -> (out [M, h*dk], attn [M, h, n])."""
    out, attn = attend(qh, kh, vh, mask, explain_weight, 1.0 / math.sqrt(dk))
    return out.reshape(out.shape[0], -1), attn


class SplitTemporalAttention(nn.Module):
    def __init__(self, n_head: int, d_model: int, d_k: int, d_node: int,
                 d_edge: int, d_time: int):
        super().__init__()
        self.n_head, self.d_k = n_head, d_k
        hd = n_head * d_k
        self.wq_node = nn.Linear(d_node, hd, bias=False)
        self.wq_time = nn.Linear(d_time, hd, bias=False)
        self.wk_node = nn.Linear(d_node, hd, bias=False)
        self.wk_edge = nn.Linear(d_edge, hd, bias=False)
        self.wk_time = nn.Linear(d_time, hd, bias=False)
        self.wv_node = nn.Linear(d_node, hd, bias=False)
        self.wv_edge = nn.Linear(d_edge, hd, bias=False)
        self.wv_time = nn.Linear(d_time, hd, bias=False)
        self.fc = nn.Linear(hd, d_model)
        self.ln = nn.LayerNorm(d_model, eps=1e-5)

    def project_node(self, x):
        """Node-part key/value projections: [..., Dn] -> two [..., h*dk]."""
        return self.wk_node(x), self.wv_node(x)

    def project_edge(self, x):
        return self.wk_edge(x), self.wv_edge(x)

    def forward(self, q_node, q_time, residual, k_nv, v_nv, k_ev, v_ev,
                ngh_time, mask=None, explain_weight=None):
        """q_node [B,Nq,Dn], q_time [B,Nq,Dt], residual [B,Nq,d_model];
        k_nv/v_nv [B,Nngh,h*dk]; k_ev/v_ev the same or None;
        ngh_time [B,Nngh,Dt]; mask [B,Nngh] bool -> (out [B,Nq,d_model],
        attn [B,Nq,h,n])."""
        b, nq, _ = q_node.shape
        n = k_nv.shape[1] // nq
        h, dk = self.n_head, self.d_k
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
            dk)
        out = self.fc(out.reshape(b, nq, h * dk))
        return self.ln(out + residual), attn.reshape(b, nq, h, n)
