"""GraphMixer: a 1-hop MLP-mixer temporal model, in training, eval and
explained form, with the explainer's ratio sweep.

Port of ``tempme_tpu/models/graphmixer.py``. Each of an anchor's n hop-0
neighbours (the tokens; a support's deeper hops are not read) gives
[edge features || frozen time encoding of the time since]; a linear
projection maps it to ``edge_dim`` channels, the mixer blocks mix across
tokens and channels, and the padded slots are zeroed before the mean over
all n slots. A node-feature branch adds to the anchor's own features the
mean over n of the neighbours' features times a softmax over
``where(valid, 0, -1e10)`` (so it divides by n twice; a row with no valid
neighbour takes uniform weights over node row 0, which is zeros). The
output layer maps [mixed channels || node part] to ``node_dim``.

The computation is float32 throughout (the JAX model's ``Dense`` layers
take no ``dtype``). Training mode is the draws: ``contrast(..., drop=...)``
takes per embedding call (src, tgt, bgd: each side is embedded once) one
``MixerDraws`` per block (``dropout_shapes``). ``explain_weights`` [B, n]
per side gate each block at its three points, the mixed tokens and the
node branch's scores (the TempME hook); ``ratio_contrast`` scores the
explainer's fidelity sweep under R hop-0 keep masks at once. Weights are
made on the CPU from ``seed`` with the JAX package's initialisers, then
moved to ``device``. ``edge_attr`` [B, n, De] per side gives the hop-0
edge features from outside in place of the support's; its padded slots are
then taken as given, not zeroed (the time part still is), as in the JAX
model.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.encodings import TimeEncode
from ..ops.gather import gather_rows
from ..ops.layers import ConcatMerge, MixerBlock, MixerDraws, dense
from ..ops.sampler import Subgraph
from ..utils.devices import resolve_device
from .common import Features


class GraphMixer(nn.Module):
    embed_calls = 3            # contrast embeds src, tgt and bgd once each
    draws_type = MixerDraws

    def __init__(self, node_dim: int, edge_dim: int, num_tokens: int,
                 num_layers: int = 2, token_expansion: float = 0.5,
                 channel_expansion: float = 4.0, dropout: float = 0.1,
                 device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.node_dim, self.edge_dim = node_dim, edge_dim
        self.time_dim = node_dim
        self.num_tokens, self.num_layers = num_tokens, num_layers
        self.dropout = dropout
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.time_encoder = TimeEncode(self.time_dim, trainable=False)
            self.projection = dense(edge_dim + self.time_dim, edge_dim)
            self.mixers = nn.ModuleList([
                MixerBlock(num_tokens, edge_dim, token_expansion,
                           channel_expansion, dropout)
                for _ in range(num_layers)])
            self.output_layer = dense(edge_dim + node_dim, node_dim)
            self.affinity_score = ConcatMerge(2 * node_dim, node_dim, 1)
        self.to(dev)

    def dropout_shapes(self, batch_size: int, n: int):
        """The shapes of one embedding call's dropout draws, a
        ``MixerDraws`` of shapes per block."""
        b, c = batch_size, self.edge_dim
        return [MixerDraws((b, c, m.token_ffn.hidden), (b, c, n),
                           (b, n, m.channel_ffn.hidden), (b, n, c))
                for m in self.mixers]

    def _tokens(self, feats: Features, cut_time, sub: Subgraph):
        """The projection's input [B, n, edge_dim + time_dim], unmasked."""
        e_feat = gather_rows(feats.edge, sub.eids[0])
        return torch.cat([e_feat, self._time_tokens(cut_time, sub)], dim=-1)

    def _time_tokens(self, cut_time, sub: Subgraph):
        return self.time_encoder(cut_time[:, None] - sub.ts[0])

    def _node_part(self, feats: Features, nodes, ngh, invalid, exp=None):
        """The anchors' features plus the mean over n of the neighbours'
        features times the softmax over the valid slots (times ``exp``).
        ``invalid`` [..., B, n] bool; returns [..., B, node_dim]."""
        valid = torch.where(invalid, -1e10, 0.0)
        scores = torch.softmax(valid, dim=-1)
        if exp is not None:
            scores = scores * exp
        agg = (gather_rows(feats.node, ngh) * scores[..., None]).mean(dim=-2)
        return agg + gather_rows(feats.node, nodes)

    def node_embed(self, feats: Features, nodes, cut_time, sub: Subgraph,
                   explain_weights: Optional[torch.Tensor] = None,
                   drop: Sequence[MixerDraws] | None = None,
                   edge_attr: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B] anchors -> [B, node_dim]. ``explain_weights`` [B, n] hop-0
        edge weights (zeroed at the padding) or None; ``drop`` one
        ``MixerDraws`` per block (training) or None (eval); ``edge_attr``
        [B, n, De] hop-0 edge features given from outside, or None."""
        ngh = sub.nodes[0]
        pad = (ngh == 0)[..., None]
        exp = None if explain_weights is None else \
            torch.where(ngh == 0, 0.0, explain_weights)
        if edge_attr is None:
            tokens = torch.where(pad, 0.0, self._tokens(feats, cut_time, sub))
        else:
            tokens = torch.cat([edge_attr, torch.where(
                pad, 0.0, self._time_tokens(cut_time, sub))], dim=-1)
        x = self.projection(tokens)
        for i, mixer in enumerate(self.mixers):
            x = mixer(x, exp, None if drop is None else drop[i])
        x = torch.where(pad, 0.0, x)
        if exp is not None:
            x = x * exp[..., None]
        node_part = self._node_part(feats, nodes, ngh, ngh == 0, exp)
        return self.output_layer(torch.cat([x.mean(dim=1), node_part],
                                           dim=-1))

    def _ratio_embed(self, feats: Features, nodes, cut_time, sub: Subgraph,
                     keep) -> torch.Tensor:
        """``node_embed`` under R hop-0 keep masks ``keep`` [R, B, n] bool
        at once (eval): a dropped slot is a padded one. The gathers, the
        time encodings and the projection run once; a dropped slot's
        projected token is the projection's bias (the projection is affine
        and a padded slot's input is zeros), and the mixer stack runs on
        the R * B rows. Returns [R, B, node_dim]."""
        ngh = sub.nodes[0]
        r, b, n = keep.shape
        pad_r = (ngh == 0)[None] | ~keep                      # [R, B, n]
        x_base = self.projection(self._tokens(feats, cut_time, sub))
        x = torch.where(pad_r[..., None], self.projection.bias,
                        x_base[None]).reshape(r * b, n, -1)
        for mixer in self.mixers:
            x = mixer(x)
        x = torch.where(pad_r.reshape(r * b, n, 1), 0.0, x)
        x = x.mean(dim=1).reshape(r, b, -1)
        node_part = self._node_part(feats, nodes, ngh, pad_r)
        return self.output_layer(torch.cat([x, node_part], dim=-1))

    # -- public API ------------------------------------------------------
    def ratio_contrast(self, feats: Features, src, tgt, bgd, cut_time,
                       sub_src, sub_tgt, sub_bgd, keep_src, keep_tgt,
                       keep_bgd):
        """The fidelity sweep: (pos, neg) logits [R, B] under R hop-0 keep
        masks [R, B, n] per side (eval; no dropout, no explain weights)."""
        s = self._ratio_embed(feats, src, cut_time, sub_src, keep_src)
        t = self._ratio_embed(feats, tgt, cut_time, sub_tgt, keep_tgt)
        g = self._ratio_embed(feats, bgd, cut_time, sub_bgd, keep_bgd)
        return (self.affinity_score(s, t).squeeze(-1),
                self.affinity_score(s, g).squeeze(-1))

    def get_node_emb(self, feats: Features, src, tgt, bgd, cut_time,
                     sub_src, sub_tgt, sub_bgd, explain_weights=None,
                     drop=None, edge_attr=None):
        """(src, tgt, bgd) embeddings; ``explain_weights``, ``drop`` and
        ``edge_attr`` per side or None."""
        exp = explain_weights or (None, None, None)
        drop = drop or (None, None, None)
        attr = edge_attr or (None, None, None)
        return tuple(self.node_embed(feats, a, cut_time, s, e, d, ea)
                     for a, s, e, d, ea in (
                         (src, sub_src, exp[0], drop[0], attr[0]),
                         (tgt, sub_tgt, exp[1], drop[1], attr[1]),
                         (bgd, sub_bgd, exp[2], drop[2], attr[2])))

    def contrast(self, feats: Features, src, tgt, bgd, cut_time,
                 sub_src: Subgraph, sub_tgt: Subgraph, sub_bgd: Subgraph,
                 explain_weights=None, drop=None, edge_attr=None):
        """(pos [B, 1], neg [B, 1]) affinity logits. ``explain_weights``:
        (exp_src, exp_tgt, exp_bgd), each [B, n] or None; ``drop``: per
        side the ``MixerDraws`` of its blocks, or None (eval);
        ``edge_attr``: per side [B, n, De] or None."""
        s, t, g = self.get_node_emb(feats, src, tgt, bgd, cut_time, sub_src,
                                    sub_tgt, sub_bgd, explain_weights, drop,
                                    edge_attr)
        return self.affinity_score(s, t), self.affinity_score(s, g)

    forward = contrast
