"""The TempME explainer for a TGN or a GraphMixer base.

Port of ``tempme_tpu/explain/tempme.py`` (``TempME`` and its parts): a
GINE-style event conv over the 3 events of each motif walk, the temporal
motif attention, the 12-class one-hot motif feature and an MLP give each
walk an importance in (0, 1); ``edge_importance`` carries it onto the
support edges (the walk -> edge scatter-max, ``ops/segment.py``) under the
dependency gate and samples it by a Beta reparameterisation in training
(its mean in eval); ``kl_sparsity_loss`` holds the importances against the
null model's motif prior. A TGN's explanation covers hops 0 and 1; a
GraphMixer reads hop 0 only, so its explainer carries the importances onto
hop 0 alone (the JAX package computes hop 1 too and drops it).

The enhance form (``train/enhance_main.py``) reads the explainer as a
predictor: ``walk_embedding`` sums each side's motif hiddens over its
walks, weighted by ``compute_walk_importance`` (recency and node degree),
beside the summed one-hot motif classes; ``enhance_predict_agg`` joins
them with the base's node embeddings and scores the positive and the
negative pair through ``_affinity`` (``aff_fc1``, relu, ``aff_fc2``).

Every parameter exists from construction on (flax creates them in
``init_all`` by running each path once). Layers start from the JAX
package's initialisers, on the CPU from ``seed``, then move to ``device``.

Random numbers enter as tensors, as in the TGN: the dropout uniforms of
each site (``ImpDraws`` for the walk importance, ``EdgeDraws`` for the
dependency gate, ``EnhanceDraws`` for the enhance form's motif attention;
a site keeps where ``u >= rate`` and scales by
``1 / (1 - rate)``) and the Beta sample's two gamma draws. The gamma draws
are taken from a generator, or passed in; either way their gradient with
respect to the shape is the implicit-reparameterisation derivative
``torch._standard_gamma_grad``, the one ``jax.random.gamma`` has.

Walk layout follows ``ops/sampler.py::Walks`` (newest event first), so slot
2 is the oldest event, the walk's query in the motif attention.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ..models.common import Features
from ..ops.encodings import TimeEncode
from ..ops.gather import gather_rows
from ..ops.layers import dense
from ..ops.sampler import Subgraph, Walks
from ..ops.segment import (class_mean, edge_cooccurrence_counts,
                           walk_to_edge_max)
from ..utils.devices import resolve_device


class WalkInputs(NamedTuple):
    """Walks and their per-walk edge co-occurrence counts (the reference
    precomputes these offline; here they are derived on the device)."""
    nodes: torch.Tensor        # [B, W, 6]
    eids: torch.Tensor         # [B, W, 3]
    ts: torch.Tensor           # [B, W, 3]
    cat: torch.Tensor          # [B, W]
    edge_count: torch.Tensor   # [B, W, 3, 3]


def make_walk_inputs(walks: Walks) -> WalkInputs:
    return WalkInputs(walks.nodes, walks.eids, walks.ts, walks.cat,
                      edge_cooccurrence_counts(walks.eids))


class ImpDraws(NamedTuple):
    """Dropout uniforms of one side's walk importance."""
    alpha: torch.Tensor    # [B, W, 1, 2]: the motif attention's weights
    hidden: torch.Tensor   # [B, W, 1, hid]: the motif attention's hidden
    head: torch.Tensor     # [B, W, hid + 12]: the head's first layer


class EnhanceDraws(NamedTuple):
    """Dropout uniforms of one side's walk embedding (the enhance form):
    the motif attention's two sites."""
    alpha: torch.Tensor    # [B, W, 1, 2]
    hidden: torch.Tensor   # [B, W, 1, hid]


class EdgeDraws(NamedTuple):
    """Dropout uniforms of one side's dependency gate."""
    dep1: torch.Tensor     # [B, 3W, hid], at rate min(1.5 * dropout, 0.99)
    dep2: torch.Tensor     # [B, 3W, hid // 2]


def _dropout(x, u, rate):
    if u is None or rate <= 0.0:
        return x
    return torch.where(u >= rate, x / (1.0 - rate), 0.0)


class _Gamma(torch.autograd.Function):
    """A standard gamma draw ``g`` at shape ``alpha`` whose gradient with
    respect to ``alpha`` is the implicit-reparameterisation derivative,
    as ``torch._standard_gamma``'s and ``jax.random.gamma``'s are."""

    @staticmethod
    def forward(ctx, alpha, g):
        ctx.save_for_backward(alpha, g)
        return g

    @staticmethod
    def backward(ctx, grad):
        alpha, g = ctx.saved_tensors
        return grad * torch._standard_gamma_grad(alpha, g), None


def beta_sample(prob, training: bool, gamma=None):
    """Beta-reparameterised importance: alpha = max(10 p, 1), beta =
    max(10 (1 - p), 1); in training ga / (ga + gb + 1e-12) with ga ~
    Gamma(alpha), gb ~ Gamma(beta), in eval the mean alpha / (alpha + beta).
    ``gamma``: the draws (ga, gb), or a ``torch.Generator`` to take them
    from."""
    alpha = torch.clamp(prob * 10.0, min=1.0)
    beta = torch.clamp((1.0 - prob) * 10.0, min=1.0)
    if not training:
        return alpha / (alpha + beta)
    if isinstance(gamma, torch.Generator):
        gamma = (torch._standard_gamma(alpha.detach(), generator=gamma),
                 torch._standard_gamma(beta.detach(), generator=gamma))
    ga = _Gamma.apply(alpha, gamma[0])
    gb = _Gamma.apply(beta, gamma[1])
    return ga / (ga + gb + 1e-12)


def kl_sparsity_loss(prob, cat, null_dist, target: float = 0.3,
                     prior: str = "empirical"):
    """The sparsity prior's KL: prob [B, W, 1], cat [B, W], null_dist [12]
    in ``CAT_ORDER``."""
    prob = prob.squeeze(-1).clamp(1e-6, 1 - 1e-6)
    if prior == "empirical":
        s = prob.mean(dim=1, keepdim=True)
        emp = s * class_mean(prob, cat, 12)
        null = target * null_dist[None, :]
        kl = ((1 - s) * torch.log((1 - s) / (1 - target + 1e-6) + 1e-6)
              + emp * torch.log(emp / (null + 1e-6) + 1e-6))
        return kl.mean()
    kl = (prob * torch.log(prob / target + 1e-6)
          + (1 - prob) * torch.log((1 - prob) / (1 - target + 1e-6) + 1e-6))
    return kl.mean()


def compute_walk_importance(time_idx, node_idx, cut_time, node_degree=None):
    """Soft walk weights: 0.5 recency + 0.5 degree sigmoid, normalised to
    mean 1 over the walks. ``node_degree`` [N], or None for a degree of 1
    at every node."""
    w = time_idx.shape[1]
    delta = (cut_time[:, None] - time_idx.amax(dim=-1)).abs()
    recency = torch.exp(-delta / (delta.std() + 1e-6))
    valid = node_idx > 0
    degs = valid.float() if node_degree is None else \
        torch.where(valid, node_degree[node_idx.long()], 0.0)
    avg_deg = degs.sum(-1) / (valid.sum(-1).float() + 1e-6)
    deg_w = torch.sigmoid((avg_deg - avg_deg.mean()) / (avg_deg.std() + 1e-6))
    imp = 0.5 * recency + 0.5 * deg_w
    return imp / (imp.sum(-1, keepdim=True) / w + 1e-6)


class EventGCN(nn.Module):
    """GINE-like event conv: fc2(relu(fc1(src + relu(tgt + lin(event)))))."""

    def __init__(self, event_dim: int, node_dim: int, hid_dim: int):
        super().__init__()
        self.lin_event = dense(event_dim, node_dim)
        self.fc1 = dense(node_dim, hid_dim)
        self.fc2 = dense(hid_dim, hid_dim)

    def forward(self, event, src_feat, tgt_feat):
        msg = torch.relu(tgt_feat + self.lin_event(event))
        return self.fc2(torch.relu(self.fc1(src_feat + msg)))


class TemporalAwareMotifAttention(nn.Module):
    """Motif attention with temporal recency reweighting: the oldest event
    attends over the two newer ones (``temporal=False`` is the plain
    variant, without the reweighting and the dropouts)."""

    def __init__(self, input_dim: int, hid_dim: int, dropout: float = 0.1,
                 temporal: bool = True, temporal_bias: float = 0.3):
        super().__init__()
        self.dropout, self.temporal = dropout, temporal
        self.temporal_bias = temporal_bias
        self.W1 = dense(input_dim, input_dim)
        self.W2 = dense(input_dim, input_dim, init=nn.init.xavier_uniform_)
        with torch.no_grad():
            self.W2.bias.fill_(0.1)
        self.fc1 = dense(input_dim, hid_dim)
        self.fc2 = dense(hid_dim, hid_dim)

    def forward(self, x, time_idx=None, cut_time=None,
                draws: Optional[ImpDraws] = None):
        """x [B, W, 3, D] -> [B, W, hid]."""
        src, tgt = x[:, :, 2:3, :], x[:, :, 0:2, :]
        wp, wq = self.W1(src), self.W2(tgt)
        scores = torch.einsum("bwqd,bwkd->bwqk", wp, wq)      # [B, W, 1, 2]
        if self.temporal and time_idx is not None and cut_time is not None:
            delta = (cut_time[:, None, None] - time_idx[:, :, :2]).abs()
            tw = torch.exp(-delta / (delta.std() + 1e-6))
            tb = self.temporal_bias
            scores = scores * (1.0 - tb + tb * tw[:, :, None, :])
        alpha = torch.softmax(scores, dim=-1)
        if self.temporal and draws is not None:
            alpha = _dropout(alpha, draws.alpha, self.dropout)
        out = src + torch.einsum("bwqk,bwkd->bwqd", alpha, wq).sum(
            dim=2, keepdim=True)
        h = torch.relu(self.fc1(out))
        if self.temporal and draws is not None:
            h = _dropout(h, draws.hidden, self.dropout)
        return self.fc2(h).squeeze(2)


class TempME(nn.Module):
    enhance_draws_type = EnhanceDraws

    def __init__(self, node_dim: int, edge_dim: int, out_dim: int = 40,
                 hid_dim: int = 64, base_type: str = "tgn",
                 prior: str = "empirical", if_cat: bool = True,
                 dropout: float = 0.1, use_temporal_guidance: bool = True,
                 use_dependency_sampling: bool = True, device=None,
                 seed: int = 0):
        super().__init__()
        if base_type == "tgat":
            raise ValueError("a TGAT base's explainer is TempMETGAT "
                             "(explain/tempme_tgat.py)")
        if base_type not in ("tgn", "graphmixer"):
            raise ValueError(f"unknown base_type {base_type}")
        dev = resolve_device(device)
        self.node_dim, self.edge_dim = node_dim, edge_dim
        self.out_dim, self.hid_dim = out_dim, hid_dim
        self.base_type, self.prior, self.if_cat = base_type, prior, if_cat
        self.hops = (0, 1) if base_type == "tgn" else (0,)
        self.dropout = dropout
        self.use_dependency_sampling = use_dependency_sampling
        time_dim = node_dim
        mlp_dim = hid_dim + 12 if if_cat else hid_dim
        node_emd_dim = hid_dim + node_dim + (12 if if_cat else 0)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.event_conv = EventGCN(edge_dim + time_dim + 3, node_dim,
                                       hid_dim)
            self.attention = TemporalAwareMotifAttention(
                2 * hid_dim, hid_dim, dropout, use_temporal_guidance)
            self.head_d1 = dense(mlp_dim, mlp_dim)
            self.head_d2 = dense(mlp_dim, hid_dim)
            self.head_d3 = dense(hid_dim, 1)
            self.time_encoder = TimeEncode(time_dim)
            if use_dependency_sampling:
                self.dep_d1 = dense(edge_dim + time_dim, hid_dim)
                self.dep_d2 = dense(hid_dim, hid_dim // 2)
                self.dep_d3 = dense(hid_dim // 2, 1)
            self.aff_fc1 = dense(2 * node_emd_dim, node_emd_dim,
                                 init=nn.init.xavier_normal_)
            self.aff_fc2 = dense(node_emd_dim, 1, init=nn.init.xavier_normal_)
        self.to(dev)

    def draw_shapes(self, batch_size: int, n_walks: int):
        """The shapes of one side's ``ImpDraws`` and ``EdgeDraws``."""
        b, w, hid = batch_size, n_walks, self.hid_dim
        return (((b, w, 1, 2), (b, w, 1, hid),
                 (b, w, hid + 12 if self.if_cat else hid)),
                ((b, 3 * w, hid), (b, 3 * w, hid // 2)))

    # ------------------------------------------------------------------
    def _walk_features(self, feats: Features, walks: WalkInputs):
        e_feat = gather_rows(feats.edge, walks.eids)          # [B, W, 3, De]
        t_feat = self.time_encoder(walks.ts[..., -1:] - walks.ts)
        event = torch.cat([e_feat, walks.edge_count, t_feat], dim=-1)
        return (event, gather_rows(feats.node, walks.nodes[..., 0::2]),
                gather_rows(feats.node, walks.nodes[..., 1::2]))

    def _motif_hidden(self, feats, walks, cut_time, draws):
        event, src_feat, tgt_feat = self._walk_features(feats, walks)
        updated = torch.cat([self.event_conv(event, src_feat, tgt_feat),
                             self.event_conv(event, tgt_feat, src_feat)],
                            dim=-1)
        return self.attention(updated, walks.ts, cut_time, draws)

    def _cat_onehot(self, cat, dtype):
        return nn.functional.one_hot(cat.long(), 12).to(dtype)

    def forward(self, feats: Features, walks: WalkInputs, cut_time,
                draws: Optional[ImpDraws] = None):
        """Walk importance [B, W, 1]; ``draws`` for training, None for
        eval."""
        h = self._motif_hidden(feats, walks, cut_time, draws)
        if self.if_cat:
            h = torch.cat([h, self._cat_onehot(walks.cat, h.dtype)], dim=-1)
        out = torch.relu(self.head_d1(h))
        if draws is not None:
            out = _dropout(out, draws.head, self.dropout)
        out = self.head_d3(torch.relu(self.head_d2(out)))
        return torch.sigmoid(out)

    def edge_importance(self, feats: Features, sub: Subgraph, graphlet_imp,
                        walks: WalkInputs, training: bool = True,
                        draws: Optional[EdgeDraws] = None, gamma=None,
                        hops=None):
        """Walk importance -> the importance of each support edge of the
        explained hops (``self.hops``, or ``hops``): (imp0 [B, n], imp1
        [B, n * n]) for a TGN, (imp0,) for a GraphMixer, 0 on padding.
        ``gamma``: the Beta sample's draws (ga0, gb0, ga1, gb1; a
        GraphMixer reads the first two) or a generator (training only)."""
        b, w, _ = walks.eids.shape
        edge_walk = walks.eids.reshape(b, w * 3)
        walk_imp = graphlet_imp.expand(b, w, 3).reshape(b, w * 3)
        if self.use_dependency_sampling:
            x = torch.cat([gather_rows(feats.edge, edge_walk),
                           self.time_encoder(walks.ts.reshape(b, w * 3))],
                          dim=-1)
            x = torch.relu(self.dep_d1(x))
            if draws is not None:
                x = _dropout(x, draws.dep1, min(self.dropout * 1.5, 0.99))
            x = torch.relu(self.dep_d2(x))
            if draws is not None:
                x = _dropout(x, draws.dep2, self.dropout)
            gate = torch.sigmoid(self.dep_d3(x).squeeze(-1))
            walk_imp = walk_imp * (0.5 + 0.5 * gate)
        imps = []
        for hop in self.hops if hops is None else hops:
            imp = walk_to_edge_max(edge_walk, walk_imp, sub.eids[hop])
            g = gamma if isinstance(gamma, torch.Generator) or gamma is None \
                else gamma[2 * hop:2 * hop + 2]
            imp = beta_sample(imp, training, g)
            imps.append(torch.where(sub.nodes[hop] == 0, 0.0, imp))
        return tuple(imps)

    def retrieve_explanation(self, feats: Features, subs, imps, walks,
                             training: bool = True, draws=None, gamma=None):
        """Per explained hop the stacked [3B, width] edge importances of the
        three sides (src, tgt, bgd). ``draws`` and ``gamma``: per side, or
        None; ``gamma`` may also be one generator for all sides."""
        per_side = [self.edge_importance(
            feats, subs[i], imps[i], walks[i], training,
            None if draws is None else draws[i],
            gamma if gamma is None or isinstance(gamma, torch.Generator)
            else gamma[i]) for i in range(3)]
        return [torch.cat([s[h] for s in per_side], dim=0)
                for h in range(len(self.hops))]

    # -- enhance form ------------------------------------------------
    def enhance_draw_shapes(self, batch_size: int, n_walks: int):
        """The shapes of one side's ``EnhanceDraws``."""
        return (batch_size, n_walks, 1, 2), (batch_size, n_walks, 1,
                                             self.hid_dim)

    def walk_embedding(self, feats: Features, walks: WalkInputs, cut_time,
                       node_degree=None,
                       draws: Optional[EnhanceDraws] = None):
        """[B, hid (+ 12)]: the motif hiddens summed over the walks, each
        weighted by its importance, beside the summed one-hot motif
        classes. ``node_degree`` [N] (ones when None) weighs the walks'
        nodes; ``draws`` the motif attention's dropout (training) or
        None."""
        h = self._motif_hidden(feats, walks, cut_time, draws)
        ww = compute_walk_importance(walks.ts, walks.nodes, cut_time,
                                     node_degree)
        h = (h * ww[..., None]).sum(dim=1)
        if self.if_cat:
            h = torch.cat([h, self._cat_onehot(walks.cat, h.dtype).sum(1)],
                          dim=-1)
        return h

    def _affinity(self, x1, x2):
        x = torch.cat([x1, x2], dim=-1)
        return self.aff_fc2(torch.relu(self.aff_fc1(x)))

    def enhance_predict_agg(self, feats: Features, cut_time, walks_src,
                            walks_tgt, walks_bgd, src_gat, tgt_gat, bgd_gat,
                            node_degree=None, draws=None):
        """(pos [B, 1], neg [B, 1]) logits of the pairs (src, tgt) and
        (src, bgd) from each side's walk embedding beside the base's node
        embedding of the side (``*_gat`` [B, node_dim]). ``draws``: per
        side an ``EnhanceDraws`` (training), or None."""
        d = draws or (None, None, None)
        src, tgt, bgd = (
            torch.cat([self.walk_embedding(feats, w, cut_time, node_degree,
                                           u), gat], dim=-1)
            for w, gat, u in ((walks_src, src_gat, d[0]),
                              (walks_tgt, tgt_gat, d[1]),
                              (walks_bgd, bgd_gat, d[2])))
        return self._affinity(src, tgt), self._affinity(src, bgd)
