"""TGAT: temporal graph attention over a k-hop support pyramid, in training,
eval and explained form, with the explainer's ratio sweep.

Port of ``tempme_tpu/models/tgat.py``. The support has hop widths n, n**2,
..., n**k for k layers; at stack layer l every remaining pyramid level i
aggregates its children (level i + 1) through layer l's 1 x n temporal
attention (``ops/attention.py``, the ``attend`` kernel) and a gated merge.
Stack layer 0 reads raw node features: each layer projects the node and
edge tables once (``project_node``, ``project_edge`` on each table) and
gathers the projected rows; deeper layers project their computed
embeddings. The query's edge part is zero, which a bias-free projection
turns into nothing, so it is skipped.

Each (layer, level) block can run under ``torch.utils.checkpoint``
(``remat``, on for 3 layers or more, as the JAX package's ``nn.remat``):
its inputs are ids, raw time deltas and the projected tables, and the
backward recomputes the gathers, time encodings and attention (the
forward kernel launches again) in place of keeping the [B, n**k, h*dk]
tensors. The dropout draws enter from outside (``AttnDraws``, one per
block), so the recompute applies the same masks.

Training mode is the draws: ``contrast(..., drop=...)`` takes, per
embedding call (src for the positive pair, tgt, src for the negative pair,
bgd: the src side is embedded twice, each with its own draws, as in the JAX
package), one ``AttnDraws`` per block in (layer, level) order
(``dropout_shapes``). ``explain_weights`` multiplies each support edge's
attention probability (the TempME hook); ``ratio_contrast`` scores the
explainer's fidelity sweep under R keep masks at once. Weights are made on
the CPU from ``seed`` with the JAX package's initialisers, then moved to
``device``.

The variant flags are the JAX model's: ``agg_method`` "attn" | "lstm" |
"mean", ``attn_mode`` "prod" | "map" (for "attn"), ``use_time`` "time" |
"pos" | "empty" (``ops/encodings.py``; "pos" ranks the children of each
parent among themselves, so ``pos_seq_len`` must be at least n). The
attn/prod blocks are the split-projection path above, whatever
``use_time``. The others (map attention, the LSTM and mean pools,
``ops/aggregators.py``) read the raw per-level [node, edge, time]
features in float32 (``_node_embed_raw``), are never checkpointed, and
have no ratio sweep: the explainer refuses such a base. Map attention
takes two dropout draws a block; the pools take none.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.aggregators import LSTMPool, MapAttnLayer, MeanPool
from ..ops.attention import AttnDraws, SplitTemporalAttention
from ..ops.encodings import make_time_encoder
from ..ops.gather import gather_rows
from ..ops.layers import ConcatMerge, GatedMerge
from ..ops.sampler import Subgraph
from ..utils.devices import resolve_device
from .common import Features


class TGATAttnLayer(nn.Module):
    """Attention over [node || edge || time] keys and the gated merge. The
    per-head width is ``ceil(model_dim / n_head)`` (the reference requires
    an exact division, which rejects e.g. 172 + 1 + 172); ``fc`` maps
    ``h * d_k`` back to ``model_dim``."""

    def __init__(self, feat_dim: int, edge_dim: int, time_dim: int,
                 n_head: int, dropout: float = 0.0,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.edge_dim = edge_dim
        model_dim = feat_dim + edge_dim + time_dim
        self.attn = SplitTemporalAttention(
            n_head=n_head, d_model=model_dim, d_k=-(-model_dim // n_head),
            d_node=feat_dim, d_edge=edge_dim, d_time=time_dim,
            dropout=dropout, compute_dtype=compute_dtype)
        self.merger = GatedMerge(model_dim, feat_dim, feat_dim, feat_dim)

    def forward(self, src, src_t, k_nv, v_nv, k_ev, v_ev, ngh_t, mask,
                explain_weight=None, draws: AttnDraws | None = None):
        """src [B, Nq, Dn], src_t [B, Nq, Dt]; the projected key and value
        parts [B, Nq*n, h*dk]; ngh_t [B, Nq*n, Dt]; mask [B, Nq*n] bool ->
        [B, Nq, Dn] float32."""
        src_e = src.new_zeros(src.shape[:2] + (self.edge_dim,))
        residual = torch.cat([src, src_e, src_t], dim=-1)
        out, _ = self.attn(src, src_t, residual, k_nv, v_nv, k_ev, v_ev,
                           ngh_t, mask=mask, explain_weight=explain_weight,
                           draws=draws)
        return self.merger(out, src)

    def sweep_parts(self, src, src_t, k_nv, v_nv, k_ev, v_ev, ngh_t,
                    shared_kv: bool):
        """The block's ratio-invariant work for ``multi_mask``: computed
        once when the ratios are swept in chunks."""
        f = self.attn.shared_kv_parts if shared_kv \
            else self.attn.multi_mask_parts
        return f(src, src_t, k_nv, v_nv, k_ev, v_ev, ngh_t)

    def multi_mask(self, src, src_t, k_nv, v_nv, k_ev, v_ev, ngh_t, q_keep,
                   kv_keep, kv_pad, parts=None):
        """The block under R keep masks (ratio sweep, eval): q_keep
        [R, B, Nq] bool; kv_keep [R, B, Nq*n] bool, or None where the
        children are never masked (then K, V and both score terms are
        computed once, ``multi_mask_shared_kv``, against the padding
        ``kv_pad`` [B, Nq*n]) -> [R, B, Nq, Dn]. ``parts``: this block's
        ``sweep_parts``, or None to compute them here."""
        if kv_keep is None:
            out = self.attn.multi_mask_shared_kv(
                src, src_t, k_nv, v_nv, k_ev, v_ev, ngh_t, q_keep, kv_pad,
                residual_zeros=self.edge_dim, parts=parts)
        else:
            out = self.attn.multi_mask(
                src, src_t, k_nv, v_nv, k_ev, v_ev, ngh_t, q_keep, kv_keep,
                residual_zeros=self.edge_dim, parts=parts)
        src_r = src[None] * q_keep[..., None].to(src.dtype)
        return self.merger(out, src_r)


class TGAT(nn.Module):
    embed_calls = 4            # contrast embeds src twice, tgt and bgd once
    draws_type = AttnDraws

    def __init__(self, node_dim: int, edge_dim: int, num_layers: int = 3,
                 n_head: int = 2, dropout: float = 0.1,
                 agg_method: str = "attn", attn_mode: str = "prod",
                 use_time: str = "time", pos_seq_len: int = 1024,
                 remat: bool = False, device=None, seed: int = 0,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        dev = resolve_device(device)
        self.node_dim, self.edge_dim = node_dim, edge_dim
        self.time_dim = node_dim
        self.num_layers, self.n_head = num_layers, n_head
        self.dropout, self.remat = dropout, remat
        self.agg_method, self.attn_mode = agg_method, attn_mode
        self.use_time = use_time
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.time_encoder = make_time_encoder(use_time, self.time_dim,
                                                  seq_len=pos_seq_len)
            if agg_method == "attn" and attn_mode == "prod":
                def block():
                    return TGATAttnLayer(node_dim, edge_dim, self.time_dim,
                                         n_head, dropout, compute_dtype)
            elif agg_method == "attn" and attn_mode == "map":
                def block():
                    return MapAttnLayer(node_dim, edge_dim, self.time_dim,
                                        n_head, dropout)
            elif agg_method == "lstm":
                def block():
                    return LSTMPool(node_dim, edge_dim, self.time_dim)
            elif agg_method == "mean":
                def block():
                    return MeanPool(node_dim, edge_dim)
            else:
                raise ValueError(f"invalid agg_method/attn_mode: "
                                 f"{agg_method}/{attn_mode}")
            self.attn_layers = nn.ModuleList([block()
                                              for _ in range(num_layers)])
            self.affinity_score = ConcatMerge(2 * node_dim, node_dim, 1)
        self.to(dev)

    @property
    def uses_split_attention(self) -> bool:
        """The attn/prod blocks: the split projections and the ``attend``
        kernel; the explainer's weights and ratio sweep need them."""
        return self.agg_method == "attn" and self.attn_mode == "prod"

    def dropout_shapes(self, batch_size: int, n: int):
        """The shapes of one embedding call's dropout draws, per block in
        (layer, level) order: the probabilities' ``[B * n**i, h, n]`` and
        ``fc``'s ``[B, n**i, d_model]`` (map attention: ``[B * n**i, 1, h,
        n]`` and ``[B * n**i, 1, d_model]``); none for the pools."""
        if self.agg_method != "attn":
            return []
        d_model = self.node_dim + self.edge_dim + self.time_dim
        if self.attn_mode == "map":
            return [((batch_size * n ** i, 1, self.n_head, n),
                     (batch_size * n ** i, 1, d_model))
                    for layer in range(self.num_layers)
                    for i in range(self.num_layers - layer)]
        return [((batch_size * n ** i, self.n_head, n),
                 (batch_size, n ** i, d_model))
                for layer in range(self.num_layers)
                for i in range(self.num_layers - layer)]

    # -- the pyramid -----------------------------------------------------
    def _time_deltas(self, cut_time, sub: Subgraph, n: int):
        """Raw dt per pyramid level: level 0 is the query's dt = 0 slot, hop
        h the parents' timestamps minus the children's. [B, n**h] floats,
        encoded inside the blocks so a recompute carries only these."""
        b = cut_time.shape[0]
        deltas = [cut_time.new_zeros((b, 1))]
        standard = cut_time[:, None]
        for t_rec in sub.ts:
            delta = standard[:, :, None] - t_rec.reshape(b, -1, n)
            deltas.append(delta.reshape(b, -1))
            standard = t_rec
        return deltas

    def _encode_delta(self, delta, n: int, level: int):
        """The time encoding of a level's raw dt [B, n**level]; "pos"
        ranks each parent's n children among themselves."""
        if self.use_time == "pos" and level > 0:
            enc = self.time_encoder(delta.reshape(-1, n))
            return enc.reshape(delta.shape[0], -1, enc.shape[-1])
        return self.time_encoder(delta)

    def _block(self, layer: int, level: int, q, d_par, child, eids, d_child,
               mask, ew, draws, edge_kv, node_tabs):
        """One (layer, level) block. Stack layer 0 (``node_tabs`` = the raw
        node table and its projected key and value tables) takes node ids
        ``q`` and ``child``; deeper layers take the computed embeddings.
        ``edge_kv`` is the layer's projected edge tables."""
        lay = self.attn_layers[layer]
        if node_tabs is not None:
            node_tab, k_tab, v_tab = node_tabs
            q = gather_rows(node_tab, q)
            k_nv, v_nv = gather_rows(k_tab, child), gather_rows(v_tab, child)
        else:
            k_nv, v_nv = lay.attn.project_node(child)
        k_ev = gather_rows(edge_kv[0], eids)
        v_ev = gather_rows(edge_kv[1], eids)
        n = d_child.shape[1] // d_par.shape[1]
        return lay(q, self._encode_delta(d_par, n, level), k_nv, v_nv, k_ev,
                   v_ev, self._encode_delta(d_child, n, level + 1), mask,
                   explain_weight=ew, draws=draws)

    def _run_block(self, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(self._block, *args, use_reentrant=False)
        return self._block(*args)

    def node_embed(self, feats: Features, src, cut_time, sub: Subgraph,
                   explain_weights: Optional[List] = None,
                   drop: Sequence[AttnDraws] | None = None) -> torch.Tensor:
        """[B] anchors -> [B, node_dim]. ``explain_weights``: per hop a
        [B, n**(h+1)] weight or None; ``drop``: one ``AttnDraws`` per block
        (training) or None (eval)."""
        if not self.uses_split_attention:
            return self._node_embed_raw(feats, src, cut_time, sub,
                                        explain_weights, drop)
        n = sub.nodes[0].shape[1]
        levels = [src[:, None]] + list(sub.nodes)
        masks = [nodes == 0 for nodes in sub.nodes]
        deltas = self._time_deltas(cut_time, sub, n)
        draws = iter(drop) if drop is not None else None
        hidden = None                     # None: the levels hold node ids
        for layer in range(self.num_layers):
            lay = self.attn_layers[layer].attn
            edge_kv = lay.project_edge(feats.edge)
            node_tabs = None
            if hidden is None:
                node_tabs = (feats.node,) + lay.project_node(feats.node)
            new_hidden = []
            for i in range(self.num_layers - layer):
                ew = explain_weights[i] if explain_weights is not None \
                    else None
                q, child = (levels[i], levels[i + 1]) if hidden is None \
                    else (hidden[i], hidden[i + 1])
                new_hidden.append(self._run_block(
                    layer, i, q, deltas[i], child, sub.eids[i],
                    deltas[i + 1], masks[i], ew,
                    None if draws is None else next(draws), edge_kv,
                    node_tabs))
            hidden = new_hidden
        return hidden[0].squeeze(1)

    def _node_embed_raw(self, feats: Features, src, cut_time, sub: Subgraph,
                        explain_weights=None, drop=None) -> torch.Tensor:
        """``node_embed`` through map attention or a pool: every block
        reads the raw per-level features, [B * n**i] parents with n
        children each, in (layer, level) order."""
        n = sub.nodes[0].shape[1]
        b = src.shape[0]
        levels = [src[:, None]] + list(sub.nodes)
        deltas = self._time_deltas(cut_time, sub, n)
        tfeat = [self._encode_delta(d, n, i) for i, d in enumerate(deltas)]
        draws = iter(drop) if drop is not None else iter(())
        hidden = [gather_rows(feats.node, lv) for lv in levels]
        for layer in range(self.num_layers):
            lay = self.attn_layers[layer]
            new_hidden = []
            for i in range(self.num_layers - layer):
                bq = b * hidden[i].shape[1]
                ew = None
                if explain_weights is not None and \
                        explain_weights[i] is not None:
                    ew = explain_weights[i].reshape(bq, n)
                out, _ = lay(hidden[i].reshape(bq, -1),
                             tfeat[i].reshape(bq, 1, -1),
                             hidden[i + 1].reshape(bq, n, -1),
                             tfeat[i + 1].reshape(bq, n, -1),
                             gather_rows(feats.edge, sub.eids[i]).reshape(
                                 bq, n, -1),
                             sub.nodes[i].reshape(bq, n) == 0,
                             explain_weight=ew, draws=next(draws, None))
                new_hidden.append(out.reshape(b, -1, out.shape[-1]))
            hidden = new_hidden
        return hidden[0].squeeze(1)

    def _ratio_embed(self, feats: Features, anchors, cut_time, sub: Subgraph,
                     keeps, chunk: int | None = None) -> torch.Tensor:
        """The pyramid under R keep masks at once (eval): ``keeps`` per hop
        [R, B, n**(h+1)] bool for hops 0 .. len(keeps) - 1 (the explanation
        covers 2; deeper hops are never masked). Stack layer 0 shares its
        gathers, projections, time encodings and, per level, the work no
        mask changes (``sweep_parts``) across the R masks; deeper layers
        fold R into the batch of the ``attend`` kernel. ``chunk`` ratios go
        through the masked work at a time (all at once by default): that
        bounds the [chunk * B, n**2, D] levels of a 3-hop pyramid, and the
        shared work is done once for all chunks. Returns [R, B, node_dim]."""
        if self.num_layers < 2 or not self.uses_split_attention:
            raise ValueError("the ratio sweep needs an attn/prod TGAT of 2 "
                             "layers or more")
        n = sub.nodes[0].shape[1]
        l, b, nk = self.num_layers, anchors.shape[0], len(keeps)
        r_all = keeps[0].shape[0]
        chunk = chunk or r_all
        levels = [anchors[:, None]] + list(sub.nodes)
        base_pad = [nodes == 0 for nodes in sub.nodes]
        deltas = self._time_deltas(cut_time, sub, n)

        lay0 = self.attn_layers[0]
        k_tab, v_tab = lay0.attn.project_node(feats.node)
        ke_tab, ve_tab = lay0.attn.project_edge(feats.edge)
        shared = []                      # per level: query, its time, parts
        for i in range(l):
            q_node = gather_rows(feats.node, levels[i])
            q_time = self._encode_delta(deltas[i], n, i)
            shared.append((q_node, q_time, lay0.sweep_parts(
                q_node, q_time, gather_rows(k_tab, levels[i + 1]),
                gather_rows(v_tab, levels[i + 1]),
                gather_rows(ke_tab, sub.eids[i]),
                gather_rows(ve_tab, sub.eids[i]),
                self._encode_delta(deltas[i + 1], n, i + 1), i >= nk)))
        edge_kv = [None] + [self.attn_layers[layer].attn.project_edge(
            feats.edge) for layer in range(1, l)]

        outs = []
        for c in range(0, r_all, chunk):
            kc = [k[c:c + chunk] for k in keeps]
            r = kc[0].shape[0]
            hidden = []
            for i, (q_node, q_time, parts) in enumerate(shared):
                if i == 0:
                    q_keep = torch.ones((r, b, 1), dtype=torch.bool,
                                        device=anchors.device)
                else:
                    q_keep = kc[i - 1] & ~base_pad[i - 1]
                kv_keep = (kc[i] & ~base_pad[i]) if i < nk else None
                hidden.append(lay0.multi_mask(
                    q_node, q_time, None, None, None, None, None, q_keep,
                    kv_keep, base_pad[i], parts=parts))  # [r, B, n**i, D]

            def tile(x):
                return x[None].expand((r,) + x.shape).reshape(
                    (r * x.shape[0],) + x.shape[1:])

            masks_r = [((base_pad[i][None] | ~kc[i]) if i < nk
                        else base_pad[i][None].expand((r,) + base_pad[i].shape)
                        ).reshape((r * b,) + base_pad[i].shape[1:])
                       for i in range(l)]
            hidden = [h.reshape((r * b,) + h.shape[2:]) for h in hidden]
            for layer in range(1, l):
                hidden = [self._block(layer, i, hidden[i], tile(deltas[i]),
                                      hidden[i + 1], tile(sub.eids[i]),
                                      tile(deltas[i + 1]), masks_r[i], None,
                                      None, edge_kv[layer], None)
                          for i in range(l - layer)]
            outs.append(hidden[0].squeeze(1).reshape(r, b, -1))
        return torch.cat(outs)

    # -- public API ------------------------------------------------------
    def ratio_contrast(self, feats: Features, src, tgt, bgd, cut_time,
                       sub_src, sub_tgt, sub_bgd, keeps_src, keeps_tgt,
                       keeps_bgd, chunk: int | None = None):
        """The fidelity sweep: (pos, neg) logits [R, B] under R per-hop
        keep masks per side (eval; no dropout, no explain weights), the
        masked work ``chunk`` ratios at a time (``_ratio_embed``)."""
        s = self._ratio_embed(feats, src, cut_time, sub_src, keeps_src, chunk)
        t = self._ratio_embed(feats, tgt, cut_time, sub_tgt, keeps_tgt, chunk)
        g = self._ratio_embed(feats, bgd, cut_time, sub_bgd, keeps_bgd, chunk)
        return (self.affinity_score(s, t).squeeze(-1),
                self.affinity_score(s, g).squeeze(-1))

    def get_node_emb(self, feats: Features, src, tgt, bgd, cut_time,
                     sub_src, sub_tgt, sub_bgd, drop=None):
        """(src, tgt, bgd) embeddings; ``drop`` per side or None."""
        drop = drop or (None, None, None)
        return tuple(self.node_embed(feats, a, cut_time, s, None, d)
                     for a, s, d in ((src, sub_src, drop[0]),
                                     (tgt, sub_tgt, drop[1]),
                                     (bgd, sub_bgd, drop[2])))

    def contrast(self, feats: Features, src, tgt, bgd, cut_time,
                 sub_src: Subgraph, sub_tgt: Subgraph, sub_bgd: Subgraph,
                 explain_weights=None, drop=None):
        """(pos [B, 1], neg [B, 1]) affinity logits. ``explain_weights``:
        ((exp_src_p, exp_tgt), (exp_src_n, exp_bgd)), each a per-hop list
        of [B, n**(h+1)] weights (None for an unweighted hop) or None.
        ``drop``: per embedding call (src_p, tgt, src_n, bgd) the
        ``AttnDraws`` of its blocks, or None (eval)."""
        if explain_weights is not None:
            (exp_src_p, exp_tgt), (exp_src_n, exp_bgd) = explain_weights
        else:
            exp_src_p = exp_tgt = exp_src_n = exp_bgd = None
        drop = drop or (None,) * 4
        src_p = self.node_embed(feats, src, cut_time, sub_src, exp_src_p,
                                drop[0])
        tgt_e = self.node_embed(feats, tgt, cut_time, sub_tgt, exp_tgt,
                                drop[1])
        pos = self.affinity_score(src_p, tgt_e)
        src_n = self.node_embed(feats, src, cut_time, sub_src, exp_src_n,
                                drop[2])
        bgd_e = self.node_embed(feats, bgd, cut_time, sub_bgd, exp_bgd,
                                drop[3])
        return pos, self.affinity_score(src_n, bgd_e)

    forward = contrast
