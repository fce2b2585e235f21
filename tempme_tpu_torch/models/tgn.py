"""TGN with node memory, in serving and training form, and as the frozen
base the TempME explainer explains.

Port of ``tempme_tpu/models/tgn.py`` with every variant of the JAX
model: the memory updater ``gru`` (flax's ``GRUCell``) or ``rnn`` (flax's
``SimpleCell``, ``tanh(i(x) + h(h))``); the message aggregator ``last``
(the batch's last message per node) or ``mean`` (the mean of the batch's
messages per node, stamped with the last one's time); the message function
``mlp`` or ``identity`` (the raw message goes to the updater as it is);
the embedding ``graph_attention`` (the attention pyramid over the
support), ``identity`` (the updated memory row) or ``time`` (Jodie:
memory * (1 + ``jodie_proj``(dt)), dt shifted and scaled by the source
side's statistics for the source and the destination side's for the
others). Modules a variant never calls have no parameters, as flax makes
none for them: an identity- or time-embedding TGN has no attention
layers, an identity message function no ``message_mlp``. The repo ships
the gru/last/mlp/graph_attention TGN
(``params/tgnn/tgn_uslegis_sampled.msgpack``).

The memory is an explicit ``TGNMemoryState`` carried from step to step, as
in the JAX package; every step returns a new state and leaves its input
untouched, so a caller keeps backups by holding references. A training step
must detach the returned state before the next step (the stored messages
are already cut from the graph, as the JAX package's ``stop_gradient``
does).

Training mode is the dropout draws: ``contrast(..., drop=...)`` takes one
``AttnDraws`` per attention call (``dropout_shapes`` gives their shapes);
without them the model is the eval form. The explainer's hooks:
``contrast(..., explain_weights=..., update_memory=False)`` weights each
support edge's attention probability and leaves the memory as it was, and
``ratio_contrast`` scores the 16-ratio fidelity sweep in one pass. The
data-parallel step's hooks: ``exchange`` (the memory write reads the global
batch) and ``shard`` (the memory's rows and the support's columns over the
mesh's ``sp`` axis, ``parallel/train.py::RowShard``; ``WHOLE``, every row
and column, by default): the state's ``memory`` and ``msg_buf`` are then
this rank's contiguous block of rows, the message function and updater
advance those rows only, the positives and messages are written to them
only, and the embeddings read the rows they need through the shard's
distributed row gather. The attention
projections run in ``compute_dtype`` (bf16 by default, as in the
JAX package; ``ops/attention.py``). The layers start from the JAX
package's initialisers, and the GRU is flax's cell (no bias on the reset
and update gates' recurrent terms), so trained weights stay comparable.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import nn

from ..ops.attention import AttnDraws, SplitTemporalAttention
from ..ops.encodings import TimeEncode
from ..ops.gather import gather_rows
from ..ops.layers import ConcatMerge, dense, lecun_normal_
from ..ops.sampler import Subgraph
from ..utils.devices import resolve_device
from .common import Features


class TGNMemoryState(NamedTuple):
    memory: torch.Tensor        # [N, Dm] float32
    last_update: torch.Tensor   # [N] float32
    msg_buf: torch.Tensor       # [N, raw_dim] float32 pending raw message
    msg_ts: torch.Tensor        # [N] float32 pending message timestamp
    msg_valid: torch.Tensor     # [N] bool


def init_memory_state(num_nodes: int, memory_dim: int, raw_dim: int,
                      device=None) -> TGNMemoryState:
    dev = resolve_device(device)
    return TGNMemoryState(
        memory=torch.zeros((num_nodes, memory_dim), device=dev),
        last_update=torch.zeros((num_nodes,), device=dev),
        msg_buf=torch.zeros((num_nodes, raw_dim), device=dev),
        msg_ts=torch.zeros((num_nodes,), device=dev),
        msg_valid=torch.zeros((num_nodes,), dtype=torch.bool, device=dev))


class Whole:
    """The memory's rows and the support's columns all on this process: the
    identity form of ``parallel/train.py::RowShard`` (the mesh's ``sp``
    axis), whose hooks the model calls. ``lo``: the first of its rows;
    ``local``: its rows of a whole table; ``columns``: its chunk of a
    hop's columns; ``gather_rows(memory, node, ids)``: the memory and
    node-feature rows that the ids (global) read, and the map of global
    ids to them; ``gather_columns(x, b)``: a side's hop-0 embeddings whole
    from its chunk ``x`` of ``b`` anchors' columns."""
    lo = 0

    @staticmethod
    def local(x):
        return x

    @staticmethod
    def columns(x):
        return x

    @staticmethod
    def gather_rows(memory, node, ids):
        return memory, node, Whole.local     # a global id is its own row

    @staticmethod
    def gather_columns(x, b):
        return x


WHOLE = Whole()


class GRUCell(nn.Module):
    """flax's ``GRUCell``: r = sigmoid(W_ir x + b_ir + W_hr h), z likewise,
    n = tanh(W_in x + b_in + r * (W_hn h + b_hn)), h' = (1 - z) n + z h.
    Unlike ``torch.nn.GRUCell`` the recurrent reset and update terms have no
    bias. ``weight_ih`` stacks (ir, iz, in) and ``weight_hh`` (hr, hz, hn),
    as ``torch.nn.GRUCell`` does; they start as flax's defaults
    (``lecun_normal`` input kernels, orthogonal recurrent kernels, zero
    biases)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        h = hidden_size
        self.weight_ih = nn.Parameter(torch.empty(3 * h, input_size))
        self.weight_hh = nn.Parameter(torch.empty(3 * h, h))
        self.bias_ih = nn.Parameter(torch.zeros(3 * h))
        self.bias_hn = nn.Parameter(torch.zeros(h))
        with torch.no_grad():
            for i in range(3):
                lecun_normal_(self.weight_ih[i * h:(i + 1) * h])
                nn.init.orthogonal_(self.weight_hh[i * h:(i + 1) * h])

    def forward(self, x, hx):
        gi = nn.functional.linear(x, self.weight_ih, self.bias_ih)
        gh = nn.functional.linear(hx, self.weight_hh)
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * (h_n + self.bias_hn))
        return (1.0 - z) * n + z * hx


class SimpleCell(nn.Module):
    """flax's ``SimpleCell``: h' = tanh(i(x) + h(h)), ``i`` with a bias,
    ``h`` without; lecun-normal input and orthogonal recurrent kernels."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.i = dense(input_size, hidden_size)
        self.h = dense(hidden_size, hidden_size, bias=False,
                       init=nn.init.orthogonal_)

    def forward(self, x, hx):
        return torch.tanh(self.i(x) + self.h(hx))


class TGNAttnLayer(nn.Module):
    """q = [feat || te(0)], k = [ngh_feat || edge || te(dt)], then a
    concat-merge back to node_dim."""

    def __init__(self, node_dim: int, edge_dim: int, time_dim: int,
                 n_head: int, dropout: float = 0.0,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        query_dim = node_dim + time_dim
        d_k = -(-query_dim // n_head)
        self.attn = SplitTemporalAttention(
            n_head=n_head, d_model=query_dim, d_k=d_k, d_node=node_dim,
            d_edge=edge_dim, d_time=time_dim, dropout=dropout,
            compute_dtype=compute_dtype)
        self.merger = ConcatMerge(query_dim + node_dim, node_dim, node_dim)

    def project_node(self, x):
        return self.attn.project_node(x)

    def project_edge(self, x):
        return self.attn.project_edge(x)

    def forward(self, src_feat, src_time_emb, k_nv, v_nv, k_ev, v_ev,
                ngh_time_emb, mask, explain_weight=None,
                draws: AttnDraws | None = None):
        """src_feat [Bq, Dn], src_time_emb [Bq, 1, Dt]; projected key and
        value parts [Bq, n, h*dk] -> ([Bq, Dn], attn [Bq, 1, h, n])."""
        q_node = src_feat[:, None, :]
        residual = torch.cat([q_node, src_time_emb], dim=-1)
        out, attn = self.attn(q_node, src_time_emb, residual, k_nv, v_nv,
                              k_ev, v_ev, ngh_time_emb, mask=mask,
                              explain_weight=explain_weight, draws=draws)
        return self.merger(out.squeeze(1), src_feat), attn

    def multi_mask(self, src_feat, src_time_emb, k_nv, v_nv, k_ev, v_ev,
                   ngh_time_emb, q_keep, kv_keep):
        """The layer under R keep masks (ratio sweep): q_keep [R, Bq],
        kv_keep [R, Bq, n] bool -> [R, Bq, node_dim]. A dropped entry acts
        as node-id-0 padding (``SplitTemporalAttention.multi_mask``)."""
        out = self.attn.multi_mask(src_feat[:, None, :], src_time_emb, k_nv,
                                   v_nv, k_ev, v_ev, ngh_time_emb,
                                   q_keep[..., None], kv_keep)
        src_r = src_feat[None] * q_keep[..., None].to(src_feat.dtype)
        return self.merger(out.squeeze(2), src_r)


class TGN(nn.Module):
    """Weights are made on the CPU from ``seed`` (the global RNG is left as
    it was), then moved to ``device`` (CUDA unless ``device="cpu"``).
    ``mean_time_shift`` and ``std_time_shift`` are the (source,
    destination) statistics of the time embedding
    (``data/events.py::compute_time_statistics``)."""

    def __init__(self, node_dim: int, edge_dim: int, num_nodes: int,
                 n_layers: int = 2, n_head: int = 2, dropout: float = 0.1,
                 message_dim: int = 100,
                 memory_updater: str = "gru", aggregator: str = "last",
                 message_function: str = "mlp",
                 embedding_type: str = "graph_attention",
                 mean_time_shift=(0.0, 0.0), std_time_shift=(1.0, 1.0),
                 device=None, seed: int = 0,
                 compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        for name, value, allowed in (
                ("memory_updater", memory_updater, ("gru", "rnn")),
                ("aggregator", aggregator, ("last", "mean")),
                ("message_function", message_function, ("mlp", "identity")),
                ("embedding_type", embedding_type,
                 ("graph_attention", "identity", "time"))):
            if value not in allowed:
                raise ValueError(f"unknown {name} {value!r}")
        dev = resolve_device(device)
        self.node_dim, self.edge_dim = node_dim, edge_dim
        self.num_nodes, self.n_layers = num_nodes, n_layers
        self.dropout = dropout
        self.aggregator, self.embedding_type = aggregator, embedding_type
        self.mean_time_shift = tuple(float(x) for x in mean_time_shift)
        self.std_time_shift = tuple(float(x) for x in std_time_shift)
        self.memory_dim = self.time_dim = node_dim
        self.raw_message_dim = 2 * self.memory_dim + edge_dim + self.time_dim
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.time_encoder = TimeEncode(self.time_dim)
            self.attn_layers = nn.ModuleList([
                TGNAttnLayer(node_dim, edge_dim, self.time_dim, n_head,
                             dropout, compute_dtype)
                for _ in range(n_layers if self.reads_support else 0)])
            self.message_mlp = None
            cell_in = self.raw_message_dim
            if message_function == "mlp":
                self.message_mlp = nn.Sequential(
                    dense(self.raw_message_dim, self.raw_message_dim // 2),
                    nn.ReLU(),
                    dense(self.raw_message_dim // 2, message_dim))
                cell_in = message_dim
            cell = GRUCell if memory_updater == "gru" else SimpleCell
            self.memory_updater = cell(cell_in, self.memory_dim)
            self.affinity_score = ConcatMerge(2 * node_dim, node_dim, 1)
            if embedding_type == "time":
                self.jodie_proj = dense(
                    1, node_dim, init=lambda w: nn.init.normal_(w, std=1.0))
                with torch.no_grad():
                    nn.init.normal_(self.jodie_proj.bias, std=1.0)
        self.to(dev)

    @property
    def reads_support(self) -> bool:
        """Whether the embeddings read the sampled supports: only the
        graph-attention embedding does, so the steps of the identity and
        time embeddings sample none."""
        return self.embedding_type == "graph_attention"

    def dropout_shapes(self, batch_size: int, n: int):
        """The shapes of one side's dropout draws: per attention layer (in
        the order ``_embed_chain`` runs them, deepest hop first) the
        probabilities' ``[Bq, h, n]`` and ``fc``'s ``[Bq, 1, d_model]``;
        none without attention layers."""
        out = []
        for i in range(len(self.attn_layers)):
            bq = batch_size * n ** (self.n_layers - 1 - i)
            attn = self.attn_layers[i].attn
            out.append(((bq, attn.n_head, n),
                        (bq, 1, self.node_dim + self.time_dim)))
        return out

    # -- memory machinery (functional) ---------------------------------
    def updated_memory(self, state: TGNMemoryState, shard=WHOLE):
        """Advance the memory rows that hold a pending message through the
        message function and the updater: (memory, last_update). The
        state's ``memory`` and ``msg_buf`` are ``shard``'s rows, and so is
        the memory returned; ``last_update`` is whole."""
        msgs = state.msg_buf if self.message_mlp is None \
            else self.message_mlp(state.msg_buf)
        new_mem = self.memory_updater(msgs, state.memory)
        valid = shard.local(state.msg_valid)
        return (torch.where(valid[:, None], new_mem, state.memory),
                torch.where(state.msg_valid, state.msg_ts, state.last_update))

    def _persist_positives(self, state, upd_memory, upd_last_update,
                           positives, shard=WHOLE) -> TGNMemoryState:
        """The advanced memory of the positives that held a pending
        message (of ``shard``'s rows)."""
        is_pos = torch.zeros(self.num_nodes, dtype=torch.bool,
                             device=positives.device)
        is_pos[positives.long()] = True
        take = is_pos & state.msg_valid
        return state._replace(
            memory=torch.where(shard.local(take)[:, None], upd_memory,
                               state.memory),
            last_update=torch.where(take, upd_last_update, state.last_update),
            msg_valid=state.msg_valid & ~is_pos)

    def _store_messages(self, state, src, tgt, src_emb, tgt_emb, cut_time,
                        eidx, feats: Features, shard=WHOLE) -> TGNMemoryState:
        """Raw messages, source side then destination side; per node the
        last one (so the destination side wins for a node in both), or with
        the ``mean`` aggregator the mean of its messages, stamped with the
        last one's time. The mean sums each node's messages as a product
        with a 0/1 matrix, so the card gives the same result run after
        run (no atomic adds). Only ``shard``'s rows of ``msg_buf`` are
        written (the flags and times are whole)."""
        e_feat = feats.edge[eidx.long()]
        nodes = torch.cat([src, tgt]).long()
        t_all = torch.cat([cut_time, cut_time])
        delta = t_all - state.last_update[nodes]
        t_enc = self.time_encoder(delta[:, None]).reshape(len(nodes), -1)
        src_emb, tgt_emb = src_emb.detach(), tgt_emb.detach()
        msgs = torch.cat([torch.cat([src_emb, tgt_emb]),
                          torch.cat([tgt_emb, src_emb]),
                          torch.cat([e_feat, e_feat]), t_enc], dim=-1)
        pos_idx = torch.arange(nodes.shape[0], device=nodes.device)
        winner = torch.full((self.num_nodes,), -1, dtype=torch.int64,
                            device=nodes.device).scatter_reduce(
            0, nodes, pos_idx, "amax")
        has_msg = winner >= 0
        w = winner.clamp(min=0)
        if self.aggregator == "last":
            agg = msgs[shard.local(w)]
        else:
            uniq, inv = torch.unique(nodes, return_inverse=True)
            onehot = (inv[None, :] == torch.arange(
                len(uniq), device=nodes.device)[:, None]).to(msgs.dtype)
            agg = state.msg_buf.new_zeros((self.num_nodes,)
                                          + state.msg_buf.shape[1:])
            agg[uniq] = (onehot @ msgs) / onehot.sum(dim=1, keepdim=True)
            agg = shard.local(agg)
        return state._replace(
            msg_buf=torch.where(shard.local(has_msg)[:, None], agg.detach(),
                                state.msg_buf),
            msg_ts=torch.where(has_msg, t_all[w], state.msg_ts),
            msg_valid=state.msg_valid | has_msg)

    # -- embedding pyramid ---------------------------------------------
    def _time_feats(self, cut_time, sub: Subgraph, hops: int, shard=WHOLE):
        """The time encodings of the first ``hops`` levels, each level's dt
        against its parent's time: [B, width, Dt] per level; hop 0 whole,
        the deeper hops ``shard``'s columns (``_embed_chain``)."""
        b = cut_time.shape[0]
        out, standard = [], cut_time[:, None]
        for i, t_rec in enumerate(sub.ts[:hops]):
            delta = standard[:, :, None] - t_rec.reshape(
                b, standard.shape[1], -1)
            out.append(self.time_encoder(delta.reshape(b, -1)))
            standard = t_rec if i else shard.columns(t_rec)
        return out

    def _embed_chain(self, feats: Features, node, memory, at, anchors,
                     cut_time, sub: Subgraph,
                     drop: Sequence[AttnDraws] | None = None,
                     explain_weights=None, edge_attr=None, shard=WHOLE):
        """The attention pyramid's embeddings [B, node_dim]. ``node`` and
        ``memory``: the node-feature and memory rows that
        ``shard.gather_rows`` gave, ``at`` its map of global ids to them;
        ``shard`` (``WHOLE``, or an sp rank's,
        ``parallel/train.py::RowShard``) holds the support's columns below
        hop 0: the layers below the root run on them and
        ``shard.gather_columns`` brings hop 0's embeddings whole for the
        root (an sp rank's root repeats its group's work; its caller
        weighs the loss). ``edge_attr``: per hop the edge features [B,
        width, De] given from outside in place of the support's own, or
        None."""
        b = anchors.shape[0]
        n = sub.nodes[0].shape[1]
        node_levels = [anchors[:, None]] + [
            shard.columns(sub.nodes[0]) if len(sub.nodes) > 1
            else sub.nodes[0]] + list(sub.nodes[1:])
        combined = node + memory                # memory added to raw features
        tfeats = self._time_feats(cut_time, sub, len(sub.ts), shard)

        num_levels = len(node_levels)
        prev_emb = None
        for i in range(num_levels - 1):
            t = num_levels - 1 - i
            layer = self.attn_layers[i]
            src_feat = gather_rows(combined, at(node_levels[t - 1])).reshape(
                -1, self.node_dim)
            bq = src_feat.shape[0]
            src_t = self.time_encoder(
                torch.zeros((bq, 1), device=src_feat.device))
            ngh_nodes = sub.nodes[0] if t == 1 else node_levels[t]
            if prev_emb is None:
                k_tab, v_tab = layer.project_node(combined)
                k_nv = gather_rows(k_tab, at(ngh_nodes)).reshape(bq, n, -1)
                v_nv = gather_rows(v_tab, at(ngh_nodes)).reshape(bq, n, -1)
            else:
                if t == 1:
                    prev_emb = shard.gather_columns(prev_emb, b)
                k_nv, v_nv = layer.project_node(prev_emb.reshape(bq, n, -1))
            if edge_attr is not None:
                e_raw = edge_attr[t - 1].reshape(bq, n, -1)
            else:
                e_raw = gather_rows(feats.edge, sub.eids[t - 1]).reshape(
                    bq, n, -1)
            k_ev, v_ev = layer.project_edge(e_raw)
            e_t = tfeats[t - 1].reshape(bq, n, -1)
            mask = (ngh_nodes == 0).reshape(bq, n)
            ew = None if explain_weights is None else \
                explain_weights[t - 1].reshape(bq, n)
            prev_emb, _ = layer(src_feat, src_t, k_nv, v_nv, k_ev, v_ev, e_t,
                                mask, explain_weight=ew,
                                draws=None if drop is None else drop[i])
        return prev_emb                          # [B, node_dim]

    def _ratio_embed(self, feats: Features, memory, anchors, cut_time,
                     sub: Subgraph, keeps):
        """The 2-hop embedding under R keep masks at once (the explainer's
        threshold test): ``keeps`` is per hop an [R, B, width] bool; an edge
        not kept behaves as node-id-0 padding. Gathers, projections and time
        encodings are computed once; the hop-1 level runs as
        ``multi_mask`` and the hop-0 level folds R into the batch of the
        ``attend`` kernel (R * B rows). Returns [R, B, node_dim]."""
        if self.n_layers != 2 or len(sub.nodes) < 2 or \
                not self.reads_support:
            raise ValueError("the ratio sweep needs a 2-layer "
                             "graph-attention TGN and 2 hops")
        b = anchors.shape[0]
        n = sub.nodes[0].shape[1]
        r = keeps[0].shape[0]
        combined = feats.node + memory
        tfeats = self._time_feats(cut_time, sub, 2)

        # hop-1 children -> hop-0 parents, all R masks in one pass
        layer2 = self.attn_layers[0]
        bq = b * n
        src_feat2 = gather_rows(combined, sub.nodes[0]).reshape(
            bq, self.node_dim)
        src_t2 = self.time_encoder(torch.zeros((bq, 1),
                                               device=src_feat2.device))
        k_tab, v_tab = layer2.project_node(combined)
        k_nv2 = gather_rows(k_tab, sub.nodes[1]).reshape(bq, n, -1)
        v_nv2 = gather_rows(v_tab, sub.nodes[1]).reshape(bq, n, -1)
        e_raw2 = gather_rows(feats.edge, sub.eids[1]).reshape(bq, n, -1)
        k_ev2, v_ev2 = layer2.project_edge(e_raw2)
        q_keep2 = (keeps[0] & (sub.nodes[0] != 0)).reshape(r, bq)
        kv_keep2 = (keeps[1] & (sub.nodes[1] != 0)).reshape(r, bq, n)
        emb0 = layer2.multi_mask(src_feat2, src_t2, k_nv2, v_nv2, k_ev2,
                                 v_ev2, tfeats[1].reshape(bq, n, -1),
                                 q_keep2, kv_keep2)          # [R, bq, Dn]

        # hop-0 level: R folds into the batch (n keys per anchor)
        layer1 = self.attn_layers[1]
        src_feat1 = gather_rows(combined, anchors[:, None]).reshape(
            b, self.node_dim)
        src_t1 = self.time_encoder(torch.zeros((b, 1),
                                               device=src_feat1.device))
        e_raw1 = gather_rows(feats.edge, sub.eids[0]).reshape(b, n, -1)
        k_ev1, v_ev1 = layer1.project_edge(e_raw1)
        k_nv1, v_nv1 = layer1.project_node(emb0.reshape(r * b, n, -1))

        def tile(x):
            return x[None].expand((r,) + x.shape).reshape(
                (r * x.shape[0],) + x.shape[1:])

        mask1 = ((sub.nodes[0] == 0)[None] | ~keeps[0]).reshape(r * b, n)
        out, _ = layer1(tile(src_feat1), tile(src_t1), k_nv1, v_nv1,
                        tile(k_ev1), tile(v_ev1),
                        tile(tfeats[0].reshape(b, n, -1)), mask1)
        return out.reshape(r, b, self.node_dim)

    def ratio_contrast(self, feats: Features, state: TGNMemoryState, src,
                       tgt, bgd, cut_time, sub_src, sub_tgt, sub_bgd,
                       keeps_src, keeps_tgt, keeps_bgd):
        """The frozen base's fidelity sweep: (pos, neg) logits [R, B] under
        R per-hop keep masks per side, in place of R stacked ``contrast``
        calls. The memory is advanced for the embeddings but not stored."""
        upd_memory, _ = self.updated_memory(state)
        s, t, b = (self._ratio_embed(feats, upd_memory, anchors, cut_time,
                                     sub, keeps)
                   for anchors, sub, keeps in ((src, sub_src, keeps_src),
                                               (tgt, sub_tgt, keeps_tgt),
                                               (bgd, sub_bgd, keeps_bgd)))
        return (self.affinity_score(s, t).squeeze(-1),
                self.affinity_score(s, b).squeeze(-1))

    # -- public API ------------------------------------------------------
    def get_node_emb(self, feats: Features, state: TGNMemoryState,
                     src, tgt, bgd, cut_time, eidx, sub_src, sub_tgt,
                     sub_bgd, drop=None, explain_weights=None,
                     update_memory: bool = True, edge_attr=None,
                     exchange=None, shard=WHOLE):
        """((src_emb, tgt_emb, bgd_emb), new_state): the memory advanced for
        the embeddings, then (``update_memory``) the positives persisted and
        the batch's messages stored; with ``update_memory=False`` the state
        comes back as it was (the explainer's frozen base). ``exchange``:
        None, or a function from this process's batch rows ``(src, tgt,
        cut_time, eidx, src_emb, tgt_emb)`` (the embeddings detached) to the
        global batch's, in the global order, applied before the memory is
        written (the data-parallel step's all-gather,
        ``parallel/train.py``). ``drop``: per
        side (src, tgt, bgd) one ``AttnDraws`` per layer (training), or
        None (eval). ``explain_weights``: per side a per-hop list of
        [B, width] float32 weights on the support edges' attention
        probabilities, or None. ``edge_attr``: per side a per-hop list of
        edge features replacing the support's, or None. The identity and
        time embeddings read neither the supports (which may be None),
        the draws nor these two. ``shard``: the memory's rows and the
        supports' columns this process holds (``WHOLE``, or its place on
        the mesh's ``sp`` axis, ``parallel/train.py::RowShard``: the
        state's memory and message rows are then its block, and the
        supports' hops below hop 0 its columns); an sp shard takes neither
        explain weights nor edge features."""
        if shard is not WHOLE and (explain_weights is not None
                                   or edge_attr is not None):
            raise ValueError("the sp-sharded embedding takes no explain "
                             "weights or edge features (ROADMAP A16d)")
        upd_memory, upd_last = self.updated_memory(state, shard)
        sides = ((src, sub_src), (tgt, sub_tgt), (bgd, sub_bgd))
        mem_rows, node_rows, at = shard.gather_rows(
            upd_memory, feats.node,
            [ids for anchors, sub in sides for ids in [anchors] + (
                list(sub.nodes) if self.reads_support else [])])
        drop = drop or (None, None, None)
        ew = explain_weights or (None, None, None)
        ea = edge_attr or (None, None, None)

        def embed(side, anchors, sub):
            if self.embedding_type == "identity":
                return mem_rows[at(anchors).long()]
            if self.embedding_type == "time":
                k = min(side, 1)        # the source's statistics, else dst's
                td = (cut_time - upd_last[anchors.long()]
                      - self.mean_time_shift[k]) / self.std_time_shift[k]
                return mem_rows[at(anchors).long()] * (
                    1.0 + self.jodie_proj(td[:, None]))
            return self._embed_chain(feats, node_rows, mem_rows, at, anchors,
                                     cut_time, sub, drop[side], ew[side],
                                     ea[side], shard)

        src_emb, tgt_emb, bgd_emb = (embed(i, anchors, sub)
                                     for i, (anchors, sub) in enumerate(sides))
        if update_memory:
            rows = (src, tgt, cut_time, eidx, src_emb, tgt_emb)
            if exchange is not None:
                rows = exchange(src, tgt, cut_time, eidx, src_emb.detach(),
                                tgt_emb.detach())
            m_src, m_tgt, m_time, m_eidx, m_src_emb, m_tgt_emb = rows
            state = self._persist_positives(state, upd_memory, upd_last,
                                            torch.cat([m_src, m_tgt]), shard)
            state = self._store_messages(state, m_src, m_tgt, m_src_emb,
                                         m_tgt_emb, m_time, m_eidx, feats,
                                         shard)
        return (src_emb, tgt_emb, bgd_emb), state

    def contrast(self, feats: Features, state: TGNMemoryState, src, tgt,
                 bgd, cut_time, eidx, sub_src, sub_tgt, sub_bgd, drop=None,
                 explain_weights=None, update_memory: bool = True,
                 edge_attr=None, exchange=None, shard=WHOLE):
        """((pos [B, 1], neg [B, 1]) affinity logits, new_state)."""
        (s, t, b), state = self.get_node_emb(
            feats, state, src, tgt, bgd, cut_time, eidx, sub_src, sub_tgt,
            sub_bgd, drop, explain_weights, update_memory, edge_attr,
            exchange, shard)
        return (self.affinity_score(s, t), self.affinity_score(s, b)), state

    forward = contrast
