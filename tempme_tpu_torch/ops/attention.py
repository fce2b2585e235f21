"""Split-projection 1-query x n-neighbour temporal attention.

Port of ``tempme_tpu/ops/attention.py`` ``SplitTemporalAttention``
(with ``multi_mask`` and ``multi_mask_shared_kv``; its
``project_node_table`` and ``project_edge_table`` are ``project_node``
and ``project_edge`` given a whole table) and ``_attend``. The key and
value projections are bias-free linears over ``[node || edge || time]``,
so they split into per-part projections: node and edge parts are
projected by the caller (once per table or per level), and only the time
part is projected per position here. The
attention core (scores, mask, softmax, dropout, explain weight, value sum)
is the ``attend`` kernel in its eval or training form
(``ops/kernels/attend.py``).

The projections and ``fc`` run in ``compute_dtype`` (bf16 by default, as
the JAX module's flax ``Dense(dtype=bfloat16)``): the parameters stay
float32, and inputs, weights and ``fc``'s bias are cast to the compute type,
so the projected parts and their sums ``k_nv + wk_time(t) + k_ev`` are bf16
and the kernel reads bf16 q, k and v; ``ln(out + residual)`` runs in
float32. Where no gradient flows to the weights (a frozen base, or under
``no_grad``) their casts are made once and reused until a weight is
written. ``compute_dtype=torch.float32`` gives the full-precision form the
parity tests hold against the JAX package at float32.

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
import weakref
from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as F

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


def _softmax_value(qh, kh, vh, masked, dk):
    """The ratio sweep's attention core as the JAX einsums compute it:
    float32 scores of the compute-type q and k, -1e10 where ``masked``,
    softmax, the probabilities cast back to the compute type, and a float32
    value sum. qh [..., h, dk], kh/vh [..., n, h, dk], masked [..., 1, n]
    -> [..., h, dk] float32."""
    scores = torch.einsum("...hd,...nhd->...hn", qh.float(), kh.float())
    scores = scores / math.sqrt(dk)
    attn = torch.softmax(scores.masked_fill(masked, -1e10), dim=-1)
    return torch.einsum("...hn,...nhd->...hd", attn.to(vh.dtype).float(),
                        vh.float())


class SplitTemporalAttention(nn.Module):
    def __init__(self, n_head: int, d_model: int, d_k: int, d_node: int,
                 d_edge: int, d_time: int, dropout: float = 0.0,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.n_head, self.d_k, self.dropout = n_head, d_k, dropout
        self.compute_dtype = compute_dtype
        self._casts = {}     # id(param) -> (weakref, data_ptr, version, cast)
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

    def _cast(self, p: torch.Tensor) -> torch.Tensor:
        """Parameter ``p`` in the compute type. Where no gradient flows to
        it (a frozen base, or under ``no_grad``) the cast is made once and
        reused until ``p`` is written in place or moved."""
        cd = self.compute_dtype
        if p.dtype == cd or (torch.is_grad_enabled() and p.requires_grad):
            return p.to(cd)
        hit = self._casts.get(id(p))
        if hit is None or hit[0]() is not p or \
                hit[1:3] != (p.data_ptr(), p._version):
            hit = (weakref.ref(p), p.data_ptr(), p._version,
                   p.detach().to(cd))
            self._casts[id(p)] = hit
        return hit[3]

    def _dense(self, layer: nn.Linear, x):
        """``layer`` in the compute type: input, weight and bias cast, as
        flax's ``Dense(dtype=...)`` does."""
        bias = None if layer.bias is None else self._cast(layer.bias)
        return F.linear(x.to(self.compute_dtype), self._cast(layer.weight),
                        bias)

    def project_node(self, x):
        """Node-part key/value projections: [..., Dn] -> two [..., h*dk].
        Given a whole feature table [N, Dn], a level's rows are then
        gathered from the two projected tables (``gather_rows``, whose
        backward sums repeated rows in segments), not projected one
        gathered row at a time: the projections are row-wise, so the
        gathered rows are the projected gathered rows."""
        return self._dense(self.wk_node, x), self._dense(self.wv_node, x)

    def project_edge(self, x):
        """As ``project_node`` for edge features (or the edge table)."""
        return self._dense(self.wk_edge, x), self._dense(self.wv_edge, x)

    def forward(self, q_node, q_time, residual, k_nv, v_nv, k_ev, v_ev,
                ngh_time, mask=None, explain_weight=None,
                draws: AttnDraws | None = None):
        """q_node [B,Nq,Dn], q_time [B,Nq,Dt], residual [B,Nq,d_model];
        k_nv/v_nv [B,Nngh,h*dk]; k_ev/v_ev the same or None;
        ngh_time [B,Nngh,Dt]; mask [B,Nngh] bool; explain_weight [B,Nngh]
        float32 or None; ``draws`` the dropout uniforms (training) or None
        (eval) -> (out [B,Nq,d_model], attn [B,Nq,h,n])."""
        b, nq, _ = q_node.shape
        n = k_nv.shape[1] // nq
        h, dk = self.n_head, self.d_k
        drop = draws is not None and self.dropout > 0.0
        q = self._dense(self.wq_node, q_node) + self._dense(self.wq_time,
                                                            q_time)
        k = k_nv + self._dense(self.wk_time, ngh_time)
        v = v_nv + self._dense(self.wv_time, ngh_time)
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
        out = self._dense(self.fc, out.reshape(b, nq, h * dk))
        if drop:
            out = torch.where(draws.fc >= self.dropout,
                              out / (1.0 - self.dropout), 0.0)
        return self.ln(out.float() + residual), attn.reshape(b, nq, h, n)

    def _residual(self, q_node, q_time, qk, r, residual_zeros):
        """The sweep's residual [R, B, Nq, d_model]: the kept query's node
        features, ``residual_zeros`` zero columns (TGAT's query edge part),
        its time encoding."""
        parts = [q_node[None] * qk.to(q_node.dtype)]
        if residual_zeros:
            parts.append(q_node.new_zeros(
                (r,) + q_node.shape[:2] + (residual_zeros,)))
        parts.append(q_time[None].expand((r,) + q_time.shape))
        return torch.cat(parts, dim=-1)

    def shared_kv_parts(self, q_node, q_time, k_nv, v_nv, k_ev, v_ev,
                        ngh_time):
        """What ``multi_mask_shared_kv`` computes once for every ratio: the
        score terms ``q_node . k`` and ``q_time . k`` [B, Nq, h, n] and the
        values [B, Nq, n, h, dk], float32 (from the compute type)."""
        b, nq, _ = q_node.shape
        n = k_nv.shape[1] // nq
        h, dk = self.n_head, self.d_k
        q_np = self._dense(self.wq_node, q_node).reshape(b, nq, h, dk)
        q_tp = self._dense(self.wq_time, q_time).reshape(b, nq, h, dk)
        k = k_nv + self._dense(self.wk_time, ngh_time)
        v = v_nv + self._dense(self.wv_time, ngh_time)
        if k_ev is not None:
            k = k + k_ev
            v = v + v_ev
        kh = k.reshape(b, nq, n, h, dk).float()
        return (torch.einsum("bqhd,bqnhd->bqhn", q_np.float(), kh),
                torch.einsum("bqhd,bqnhd->bqhn", q_tp.float(), kh),
                v.reshape(b, nq, n, h, dk).float())

    def multi_mask_shared_kv(self, q_node, q_time, k_nv, v_nv, k_ev, v_ev,
                             ngh_time, q_keep, kv_pad, residual_zeros=0,
                             parts=None):
        """The sweep's form for a level whose children are never masked (the
        3-layer TGAT's deepest level: the explanation covers hops 0-1, so
        hop-2 keys do not depend on the ratio). K, V and the two score terms
        ``q_node . k`` and ``q_time . k`` are computed once
        (``shared_kv_parts``, which a caller sweeping the ratios in chunks
        passes as ``parts``); per ratio only ``q_keep * s_node + s_time``,
        the softmax and the value sum run. ``q_keep`` [R, B, Nq] bool,
        ``kv_pad`` [B, Nq*n] bool (the base padding) -> [R, B, Nq, d_model]
        float32."""
        s_np, s_tp, vh = parts or self.shared_kv_parts(
            q_node, q_time, k_nv, v_nv, k_ev, v_ev, ngh_time)
        b, nq, h, n = s_np.shape
        dk, r = self.d_k, q_keep.shape[0]
        qk = q_keep.float().reshape(r, b, nq, 1, 1)
        scores = (s_np[None] * qk + s_tp[None]) / math.sqrt(dk)
        attn = torch.softmax(scores.masked_fill(
            kv_pad.reshape(1, b, nq, 1, n), -1e10), dim=-1)
        out = torch.einsum("rbqhn,bqnhd->rbqhd",
                           attn.to(self.compute_dtype).float(), vh)
        out = self._dense(self.fc, out.reshape(r, b, nq, h * dk))
        residual = self._residual(q_node, q_time, q_keep[..., None], r,
                                  residual_zeros)
        return self.ln(out.float() + residual)

    def multi_mask_parts(self, q_node, q_time, k_nv, v_nv, k_ev, v_ev,
                         ngh_time):
        """What ``multi_mask`` computes once for every ratio: the query's
        node and time projections, the keys' and values' node parts and
        their time (plus edge) parts."""
        k_t = self._dense(self.wk_time, ngh_time)
        v_t = self._dense(self.wv_time, ngh_time)
        if k_ev is not None:
            k_t = k_t + k_ev
            v_t = v_t + v_ev
        return (self._dense(self.wq_node, q_node),
                self._dense(self.wq_time, q_time), k_nv, v_nv, k_t, v_t)

    def multi_mask(self, q_node, q_time, k_nv, v_nv, k_ev, v_ev, ngh_time,
                   q_keep, kv_keep, residual_zeros=0, parts=None):
        """The ratio sweep's form (eval only): the attention under R keep
        masks at once. A dropped entry behaves as node-id-0 padding: its
        projected node parts are scaled by 0 (the node projections are
        bias-free, so that is the zero row's projection) and its score is
        masked; the time and edge parts stay. Projections are shared by the
        R masks (``multi_mask_parts``, which a caller sweeping the ratios in
        chunks passes as ``parts``); only the keep scaling, scores, softmax
        and value sum carry the R axis. ``q_keep`` [R, B, Nq] / ``kv_keep``
        [R, B, Nq*n] bool (True = kept) -> [R, B, Nq, d_model] float32.
        ``residual_zeros`` zero columns sit between the query's node and
        time parts of the residual (TGAT's query has a zero edge part;
        TGN's has none)."""
        q_np, q_tp, k_nv, v_nv, k_t, v_t = parts or self.multi_mask_parts(
            q_node, q_time, k_nv, v_nv, k_ev, v_ev, ngh_time)
        b, nq, _ = q_node.shape
        n = k_nv.shape[1] // nq
        h, dk = self.n_head, self.d_k
        r = q_keep.shape[0]
        cd = self.compute_dtype
        qk = q_keep.to(cd)[..., None]                     # [R, B, Nq, 1]
        kk = kv_keep.to(cd).reshape(r, b, nq, n, 1)
        q_r = q_np[None] * qk + q_tp[None]
        k_r = k_nv.reshape(1, b, nq, n, -1) * kk + k_t.reshape(b, nq, n, -1)
        v_r = v_nv.reshape(1, b, nq, n, -1) * kk + v_t.reshape(b, nq, n, -1)
        out = _softmax_value(q_r.reshape(r, b, nq, h, dk),
                             k_r.reshape(r, b, nq, n, h, dk),
                             v_r.reshape(r, b, nq, n, h, dk),
                             ~kv_keep.reshape(r, b, nq, 1, n), dk)
        out = self._dense(self.fc, out.reshape(r, b, nq, h * dk))
        residual = self._residual(q_node, q_time, qk, r, residual_zeros)
        return self.ln(out.float() + residual)
