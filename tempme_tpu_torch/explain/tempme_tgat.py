"""The TempME explainer for a TGAT base.

Port of ``tempme_tpu/explain/tempme_tgat.py``. Each walk's three events
become [edge || dt encoding || source node || target node] features; a
post-LN transformer encoder layer runs over the three events, their mean
goes through an MLP, a second encoder layer attends across the walks, and
an MLP over [walk || anchor node || other node] gives each walk an
importance in (0, 1). ``edge_importance`` carries it onto the hop-0 and
hop-1 support edges (the walk -> edge scatter-max, ``ops/segment.py``),
samples it by the Beta reparameterisation in training and passes it through
unchanged in eval (the reference's TGAT explainer has no dependency gate).

The encoder layers follow flax's ``MultiHeadDotProductAttention`` and
``LayerNorm`` (epsilon 1e-6, where ``torch.nn.LayerNorm`` defaults to
1e-5): q, k, v ``[L, heads, head_dim]`` with biases, ``head_dim`` the
model width rounded up to a multiple of the heads over the heads (86 at
width 688), q scaled by ``1 / sqrt(head_dim)``, dropout on the attention
weights with one mask for every batch row and head, ``out`` mapping the
heads back to the width.

The enhance form (``train/enhance_main.py``) reads the explainer as a
predictor: ``walk_embedding`` encodes each walk as above, appends its
one-hot motif class, runs ``walk_enc_cat`` (the encoder layer at width
``out_dim + 12``, its heads' width rounded up: 56 / 8 = 7 at the
defaults) across the walks and weighs each walk by
``compute_walk_importance``; ``_affinity`` joins two sides along the walk
axis, scores each walk with ``aff_fc`` and sums the scores.

Dropout uniforms are drawn by the caller and passed in (``TGATImpDraws``
or, in the enhance form, ``TGATEnhanceDraws``, one side's, of the shapes
``draw_shapes`` or ``enhance_draw_shapes`` gives; None in eval); the Beta
sample's gamma draws come from a generator or are passed in, as in
``explain/tempme.py``. Layers start from the JAX
package's initialisers, on the CPU from ``seed``, then move to ``device``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from ..models.common import Features
from ..ops.encodings import TimeEncode
from ..ops.gather import gather_rows
from ..ops.layers import dense
from ..ops.sampler import Subgraph
from ..ops.segment import walk_to_edge_max
from ..utils.devices import resolve_device
from .tempme import (LOCAL_STATS, WalkInputs, compute_walk_importance,
                     sample_edges, side_gammas, stat_inputs)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class TGATImpDraws(NamedTuple):
    """Dropout uniforms of one side's walk importance: per encoder layer
    (``ev_*`` over the events of each walk, ``walk_*`` across the walks)
    the attention weights' mask, shared by the batch rows and heads, the
    two residual branches and the feed-forward hidden; then the walk MLP's
    hidden and output and the head's hidden."""
    ev_attn: torch.Tensor      # [1, 1, 3, 3]
    ev_res1: torch.Tensor      # [B * W, 3, D]
    ev_ff: torch.Tensor        # [B * W, 3, 32 * out]
    ev_res2: torch.Tensor      # [B * W, 3, D]
    mlp_h: torch.Tensor        # [B, W, hid]
    mlp_out: torch.Tensor      # [B, W, out]
    walk_attn: torch.Tensor    # [1, 1, W, W]
    walk_res1: torch.Tensor    # [B, W, out]
    walk_ff: torch.Tensor      # [B, W, 32 * out]
    walk_res2: torch.Tensor    # [B, W, out]
    head: torch.Tensor         # [B, W, hid]


_NO_DRAWS = TGATImpDraws(*(None,) * len(TGATImpDraws._fields))  # eval


class TGATEnhanceDraws(NamedTuple):
    """Dropout uniforms of one side's walk embedding (the enhance form):
    the event encoder's and the walk MLP's, as in ``TGATImpDraws``, then
    ``walk_enc_cat``'s attention mask (shared by the batch rows and
    heads), its two residual branches and its feed-forward hidden."""
    ev_attn: torch.Tensor      # [1, 1, 3, 3]
    ev_res1: torch.Tensor      # [B * W, 3, D]
    ev_ff: torch.Tensor        # [B * W, 3, 32 * out]
    ev_res2: torch.Tensor      # [B * W, 3, D]
    mlp_h: torch.Tensor        # [B, W, hid]
    mlp_out: torch.Tensor      # [B, W, out]
    cat_attn: torch.Tensor     # [1, 1, W, W]
    cat_res1: torch.Tensor     # [B, W, out + 12]
    cat_ff: torch.Tensor       # [B, W, 32 * out]
    cat_res2: torch.Tensor     # [B, W, out + 12]


_NO_ENHANCE_DRAWS = TGATEnhanceDraws(
    *(None,) * len(TGATEnhanceDraws._fields))


def _dropout(x, u, rate: float):
    """Inverted dropout by the uniforms ``u`` (keep where u >= rate), which
    broadcast over x's leading axes where shorter. No ``u``: eval."""
    if u is None or rate <= 0.0:
        return x
    return torch.where(u >= rate, x / (1.0 - rate), 0.0)


class MultiHeadAttention(nn.Module):
    """flax's ``MultiHeadDotProductAttention`` over one sequence (self
    attention): ``query``, ``key``, ``value`` [d_model -> heads * head_dim]
    and ``out`` [heads * head_dim -> d_model], all with biases."""

    def __init__(self, d_model: int, n_head: int, dropout: float = 0.0):
        super().__init__()
        qkv = _round_up(d_model, n_head)
        self.n_head, self.head_dim, self.dropout = n_head, qkv // n_head, \
            dropout
        self.query = dense(d_model, qkv)
        self.key = dense(d_model, qkv)
        self.value = dense(d_model, qkv)
        self.out = dense(qkv, d_model)

    def forward(self, x, u=None):
        """x [B, L, D] -> [B, L, D]; ``u`` the weights' dropout uniforms
        [1, 1, L, L] or None."""
        b, l, _ = x.shape
        h, hd = self.n_head, self.head_dim
        q = self.query(x).reshape(b, l, h, hd) / math.sqrt(hd)
        k = self.key(x).reshape(b, l, h, hd)
        v = self.value(x).reshape(b, l, h, hd)
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        w = _dropout(w, u, self.dropout)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, l, h * hd)
        return self.out(out)


class TransformerEncoderLayer(nn.Module):
    """Post-LN encoder layer with a ReLU feed-forward block (the
    reference's ``torch.nn.TransformerEncoderLayer`` as the JAX package
    writes it in flax)."""

    def __init__(self, d_model: int, n_head: int, d_ff: int,
                 dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(d_model, n_head, dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-6)
        self.fc1 = dense(d_model, d_ff)
        self.fc2 = dense(d_ff, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, x, draws=(None,) * 4):
        """``draws``: the uniforms of the attention weights, the first
        residual, the feed-forward hidden and the second residual, each
        None in eval."""
        u_attn, u_res1, u_ff, u_res2 = draws
        x = self.norm1(x + _dropout(self.self_attn(x, u_attn), u_res1,
                                    self.dropout))
        h = _dropout(torch.relu(self.fc1(x)), u_ff, self.dropout)
        return self.norm2(x + _dropout(self.fc2(h), u_res2, self.dropout))


class TempMETGAT(nn.Module):
    enhance_draws_type = TGATEnhanceDraws

    def __init__(self, node_dim: int, edge_dim: int, out_dim: int = 40,
                 hid_dim: int = 64, n_head: int = 8, dropout: float = 0.1,
                 if_attn: bool = True, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.node_dim, self.edge_dim = node_dim, edge_dim
        self.out_dim, self.hid_dim = out_dim, hid_dim
        self.dropout, self.if_attn = dropout, if_attn
        time_dim = node_dim
        gru_dim = edge_dim + time_dim + 2 * node_dim
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.time_encoder = TimeEncode(time_dim)
            self.event_enc = TransformerEncoderLayer(gru_dim, n_head,
                                                     32 * out_dim, dropout)
            self.mlp_attn_d1 = dense(gru_dim, hid_dim)
            self.mlp_attn_d2 = dense(hid_dim, out_dim)
            self.walk_enc = TransformerEncoderLayer(out_dim, n_head,
                                                    32 * out_dim, dropout)
            self.walk_enc_cat = TransformerEncoderLayer(
                out_dim + 12, n_head, 32 * out_dim, dropout)
            self.head_d1 = dense(out_dim + 2 * node_dim, hid_dim)
            self.head_d2 = dense(hid_dim, 1)
            self.aff_fc = dense(out_dim + 12, 1, init=nn.init.xavier_normal_)
        self.to(dev)

    def _combined_features(self, feats: Features, walks: WalkInputs):
        """[B, W, 3, edge + time + 2 node] per walk event."""
        return torch.cat([gather_rows(feats.edge, walks.eids),
                          self.time_encoder(walks.ts[..., -1:] - walks.ts),
                          gather_rows(feats.node, walks.nodes[..., 0::2]),
                          gather_rows(feats.node, walks.nodes[..., 1::2])],
                         dim=-1)

    def draw_shapes(self, batch_size: int, n_walks: int):
        """The shapes of one side's ``TGATImpDraws``."""
        b, w = batch_size, n_walks
        d = self.edge_dim + 3 * self.node_dim
        out, ff = self.out_dim, 32 * self.out_dim
        return ((1, 1, 3, 3), (b * w, 3, d), (b * w, 3, ff), (b * w, 3, d),
                (b, w, self.hid_dim), (b, w, out), (1, 1, w, w), (b, w, out),
                (b, w, ff), (b, w, out), (b, w, self.hid_dim))

    def attention_encode(self, x, draws: Optional[TGATImpDraws] = None):
        """[B, W, 3, D] -> [B, W, out_dim]."""
        b, w, l, d = x.shape
        u = _NO_DRAWS if draws is None else draws
        h = self.event_enc(x.reshape(b * w, l, d),
                           (u.ev_attn, u.ev_res1, u.ev_ff, u.ev_res2))
        h = torch.relu(self.mlp_attn_d1(h.mean(dim=1).reshape(b, w, d)))
        h = self.mlp_attn_d2(_dropout(h, u.mlp_h, self.dropout))
        return _dropout(h, u.mlp_out, self.dropout)

    def forward(self, feats: Features, walks: WalkInputs, src_idx, cut_time,
                tgt_idx, draws: Optional[TGATImpDraws] = None):
        """Walk importance [B, W, 1] of the walks of anchor ``src_idx``
        given the other node ``tgt_idx``; ``draws`` the dropout uniforms
        (training), None in eval. ``cut_time`` is not read, as in the
        reference."""
        u = _NO_DRAWS if draws is None else draws
        g = self.attention_encode(self._combined_features(feats, walks), u)
        if self.if_attn:
            g = self.walk_enc(g, (u.walk_attn, u.walk_res1, u.walk_ff,
                                  u.walk_res2))
        w = g.shape[1]
        src = gather_rows(feats.node, src_idx)[:, None].expand(-1, w, -1)
        tgt = gather_rows(feats.node, tgt_idx)[:, None].expand(-1, w, -1)
        h = torch.relu(self.head_d1(torch.cat([g, src, tgt], dim=-1)))
        return torch.sigmoid(self.head_d2(_dropout(h, u.head, self.dropout)))

    def edge_importance(self, feats: Features, sub: Subgraph, graphlet_imp,
                        walks: WalkInputs, training: bool = True,
                        gamma=None):
        """Walk importance -> (imp0 [B, n], imp1 [B, n * n]) on the hop-0
        and hop-1 support edges, 0 on padding: the walk -> edge max, then
        in training the Beta sample (``gamma``: a generator, or the draws
        (ga0, gb0, ga1, gb1)); in eval the max itself."""
        return self.sample_edges(self.edge_probs(sub, graphlet_imp, walks),
                                 sub, training, gamma)

    @staticmethod
    def edge_probs(sub: Subgraph, graphlet_imp, walks: WalkInputs):
        """Per hop (0, 1) the walk -> edge max of the walk importance
        [B, width]: the Beta sample's probabilities."""
        b, w, _ = walks.eids.shape
        edge_walk = walks.eids.reshape(b, w * 3)
        walk_imp = graphlet_imp.expand(b, w, 3).reshape(b, w * 3)
        return [walk_to_edge_max(edge_walk, walk_imp, sub.eids[hop])
                for hop in (0, 1)]

    @staticmethod
    def sample_edges(probs, sub: Subgraph, training: bool, gamma):
        """In training the Beta sample of ``probs``, in eval the
        probabilities themselves; 0 where the support is padding."""
        if training:
            return sample_edges(probs, sub, True, gamma, (0, 1))
        return tuple(torch.where(sub.nodes[hop] == 0, 0.0, p)
                     for hop, p in enumerate(probs))

    def retrieve_explanation(self, feats: Features, subs, imps, walks,
                             training: bool = True, gamma=None):
        """Per hop the stacked [3B, width] edge importances of the three
        sides (src, tgt, bgd); ``gamma`` one generator, per side the draws,
        or a function from the sides' per-hop probabilities to per side
        the draws (training only)."""
        probs = [self.edge_probs(subs[i], imps[i], walks[i])
                 for i in range(3)]
        per_side = [self.sample_edges(p, subs[i], training, g)
                    for i, (p, g) in enumerate(zip(
                        probs, side_gammas(gamma, probs, training)))]
        return [torch.cat([s[h] for s in per_side], dim=0) for h in (0, 1)]

    # -- enhance form ------------------------------------------------
    def enhance_draw_shapes(self, batch_size: int, n_walks: int):
        """The shapes of one side's ``TGATEnhanceDraws``."""
        b, w, cat = batch_size, n_walks, self.out_dim + 12
        return self.draw_shapes(b, w)[:6] + (
            (1, 1, w, w), (b, w, cat), (b, w, 32 * self.out_dim), (b, w, cat))

    def stat_inputs(self, walks: WalkInputs, cut_time, node_degree=None,
                    enhance: bool = False) -> dict:
        """One side's batch statistics' inputs (``stat_inputs``): none in
        the explainer form (its walk encoding reads no batch statistic),
        the walk weights' in the enhance form."""
        return stat_inputs(walks, cut_time, node_degree, False, enhance)

    def walk_embedding(self, feats: Features, walks: WalkInputs, cut_time,
                       node_degree=None,
                       draws: Optional[TGATEnhanceDraws] = None,
                       stats=LOCAL_STATS):
        """[B, W, out + 12]: each walk's encoding beside its one-hot motif
        class, attended across the walks by ``walk_enc_cat``, times the
        walk's importance (``node_degree`` [N], ones when None). ``draws``
        the dropout uniforms (training) or None; ``stats`` the batch
        statistics."""
        u = _NO_ENHANCE_DRAWS if draws is None else draws
        g = self.attention_encode(self._combined_features(feats, walks), u)
        g = torch.cat([g, nn.functional.one_hot(walks.cat.long(), 12)
                       .to(g.dtype)], dim=-1)
        if self.if_attn:
            g = self.walk_enc_cat(g, (u.cat_attn, u.cat_res1, u.cat_ff,
                                      u.cat_res2))
        ww = compute_walk_importance(walks.ts, walks.nodes, cut_time,
                                     node_degree, stats)
        return g * ww[..., None]

    def _affinity(self, x1, x2):
        """Two sides' [B, W, F] walk embeddings joined along the walk axis,
        each walk scored by ``aff_fc``, the 2W scores summed: [B, 1]."""
        z = self.aff_fc(torch.cat([x1, x2], dim=1)).squeeze(-1)
        return z.sum(dim=-1, keepdim=True)

    def enhance_predict_agg(self, feats: Features, cut_time, walks_src,
                            walks_tgt, walks_bgd, node_degree=None,
                            draws=None, stats=None):
        """(pos [B, 1], neg [B, 1]) logits of the pairs (src, tgt) and
        (src, bgd) from the walks alone. ``draws``: per side a
        ``TGATEnhanceDraws`` (training), or None; ``stats``: per side the
        batch statistics, or None (each side's own)."""
        d = draws or (None, None, None)
        st = stats or (LOCAL_STATS,) * 3
        src, tgt, bgd = (self.walk_embedding(feats, w, cut_time, node_degree,
                                             u, s)
                         for w, u, s in ((walks_src, d[0], st[0]),
                                         (walks_tgt, d[1], st[1]),
                                         (walks_bgd, d[2], st[2])))
        return self._affinity(src, tgt), self._affinity(src, bgd)
