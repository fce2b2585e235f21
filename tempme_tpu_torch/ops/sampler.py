"""Temporal neighbour sampling, the k-hop support and the 3-event temporal
motif walks.

Port of ``tempme_tpu/ops/sampler.py:61-289,524-604``. Random draws
enter as tensors so that a test can replay ``jax.random`` draws in JAX's
split order: ``find_k_hop`` takes one ``[B * n**l, n]`` uniform tensor per
hop ``l``, which is what ``jax.random.uniform(sub, (q, n))`` gives after
``key, sub = split(key)`` per hop, and ``find_k_walks`` takes the two
events' uniforms (``WalkDraws``). On the card the draws come from a
``torch.Generator`` (``train/loops.py::draw_support``, ``draw_walks``).

Besides the uniform mode, ``sample_neighbors`` has the JAX package's
exp-decay mode (``bias > 0``: a multinomial with weights exp(-bias * dt),
sorted picks) and its ``binary`` mode (the same draw, not sorted). They
are Gumbel-argmax scans over each history in chunks of 128 events
(``decay_pick``), plain PyTorch on every device, as the JAX package never
sends them to its kernel; their Gumbels enter as tensors too, ``[chunks,
Q, n, 128]`` per hop (``decay_chunks``, ``draw_gumbel``), which is what
``jax.random.gumbel(fold_in(key, c), (Q, n, 128))`` gives for chunk c. No
driver reaches these modes, in either package.

The sampling itself is three kernels (``ops/kernels``): ``sample_rows``
(the cut's search, the picks and the three gathers in one launch per hop; its
plain version holds ``cut_by_time``, ``cut_by_edge`` and ``uniform_pick``),
``sample_union`` (a walk's second event) and ``sample_masked`` (its third).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from .kernels.sample_masked import sample_masked
from .kernels.sample_rows import cut_history, sample_rows
from .kernels.sample_union import sample_union

CHUNK = 128          # events a decay-sampling step scans per history


class Subgraph(NamedTuple):
    """k-hop temporal support: hop l arrays have width n**(l+1)."""
    nodes: Tuple[torch.Tensor, ...]   # each [B, n**(l+1)] int32
    eids: Tuple[torch.Tensor, ...]    # each [B, n**(l+1)] int32
    ts: Tuple[torch.Tensor, ...]      # each [B, n**(l+1)] float32


def _chunks(cut: torch.Tensor) -> int:
    return -(-int(cut.max()) // CHUNK) if cut.numel() else 0


def decay_chunks(g, nodes: torch.Tensor, times: torch.Tensor,
                 eids: torch.Tensor | None = None) -> int:
    """The number of 128-event chunks ``decay_pick`` scans for these
    queries: the longest cut history's, rounded up."""
    return _chunks(cut_history(g, nodes, times, eids)[1])


def draw_gumbel(generator: torch.Generator, chunks: int, q: int, n: int,
                device) -> torch.Tensor:
    """[chunks, Q, n, 128] standard Gumbels from ``generator``, as
    ``jax.random.gumbel`` makes them: -log(-log(u)), u uniform in
    [tiny, 1)."""
    u = torch.rand((chunks, q, n, CHUNK), generator=generator, device=device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def decay_pick(g, gumbel: torch.Tensor, start, cut, times, n: int,
               bias: float, sort: bool = True) -> torch.Tensor:
    """Multinomial picks with replacement, weights exp(-bias * (t - ts)),
    in [0, cut) per query: Gumbel-argmax over each history, 128 events a
    step, with the JAX package's arithmetic (``-bias * (t - ts)`` then
    ``+ gumbel``, the first argmax of a chunk, a strictly larger score to
    replace the running best). ``gumbel`` [C, Q, n, 128] must cover the
    longest history; -> [Q, n] int64, sorted when ``sort``, 0 where the
    cut is empty."""
    q, chunks = start.shape[0], _chunks(cut)
    if gumbel.dim() != 4 or gumbel.shape[0] < chunks or \
            tuple(gumbel.shape[1:]) != (q, n, CHUNK):
        raise ValueError(f"gumbel must be [>= {chunks}, {q}, {n}, {CHUNK}], "
                         f"got {tuple(gumbel.shape)}")
    last = max(g.ngh_ts.shape[0] - 1, 0)
    best_score = torch.full((q, n), -torch.inf, device=gumbel.device)
    best_idx = torch.zeros((q, n), dtype=torch.int64, device=gumbel.device)
    offs = torch.arange(CHUNK, device=gumbel.device)
    for c in range(chunks):
        o = c * CHUNK + offs                                 # [128]
        pos = (start[:, None] + o).clamp(max=last)
        logw = -bias * (times[:, None] - g.ngh_ts[pos])      # [Q, 128]
        score = torch.where((o < cut[:, None])[:, None, :],
                            logw[:, None, :] + gumbel[c], -torch.inf)
        chunk_best, arg = score.max(dim=-1)
        take = chunk_best > best_score
        best_score = torch.where(take, chunk_best, best_score)
        best_idx = torch.where(take, c * CHUNK + arg, best_idx)
    return torch.sort(best_idx, dim=1).values if sort else best_idx


def sample_neighbors(g, u: torch.Tensor, nodes: torch.Tensor,
                     times: torch.Tensor, n: int, bias: float = 0.0,
                     eids: torch.Tensor | None = None,
                     sample_method: str = "multinomial"):
    """k=1 temporal neighbour sampling -> ([Q,n] node, [Q,n] eid, [Q,n] ts),
    with replacement, zero-padded. With ``eids`` the history is cut at each
    edge's timestamp (e-path). ``sample_method="multinomial"`` at ``bias``
    0 is the uniform mode (the ``sample_rows`` kernel), ``u`` the [Q, n]
    uniforms, the picks sorted by position; at ``bias`` > 0 the exp-decay
    mode, sorted, and ``"binary"`` the same draw unsorted (at any
    ``bias``), ``u`` then the [C, Q, n, 128] Gumbels (``decay_pick``)."""
    if sample_method not in ("multinomial", "binary"):
        raise ValueError(f"unknown sample_method {sample_method!r}")
    nodes = nodes.to(torch.int32)
    eids = None if eids is None else eids.to(torch.int32)
    if sample_method == "multinomial" and bias == 0.0:
        if u.shape != (nodes.shape[0], n):
            raise ValueError(f"u must be [{nodes.shape[0]}, {n}], got "
                             f"{tuple(u.shape)}")
        return sample_rows(g, nodes, times, u, eids)
    start, cut = cut_history(g, nodes, times, eids)
    idx = decay_pick(g, u, start, cut, times, n, bias,
                     sort=sample_method == "multinomial")
    pos = (start[:, None] + idx).clamp(max=max(g.ngh_ts.shape[0] - 1, 0))
    valid = cut[:, None] > 0
    zero = torch.zeros((), dtype=torch.int32, device=nodes.device)
    return (torch.where(valid, g.ngh_node[pos], zero),
            torch.where(valid, g.ngh_eid[pos], zero),
            torch.where(valid, g.ngh_ts[pos], zero.to(torch.float32)))


def find_k_hop(g, draws: Sequence[torch.Tensor], src: torch.Tensor,
               times: torch.Tensor, k: int, n: int,
               eids: torch.Tensor | None = None, bias: float = 0.0,
               sample_method: str = "multinomial",
               columns=None) -> Subgraph:
    """Recursive k-hop support, widths n, n**2, ..., n**k. Hop 0 samples
    each (src, t) from its strict history (cut at ``eids`` when given);
    hop l > 0 samples each previous-hop event's endpoint with the history
    cut at that event's edge. ``draws[l]`` is hop l's [B * n**l, n] uniform
    tensor, or in the exp-decay and binary modes (``bias``,
    ``sample_method``, as ``sample_neighbors``) its Gumbels. ``columns``:
    None, or a map of hop 0's [B, n] arrays to the columns whose children
    the deeper hops sample (an sp rank's chunk,
    ``parallel/train.py::RowShard``; hop 0 is returned whole, hop l of
    width n**l / sp then, ``draws[l]`` cut to match)."""
    b = src.shape[0]
    nodes, es, tss = [], [], []
    cur_n, cur_t, cur_e = src, times, eids
    for layer in range(k):
        nn_, ne, nt = sample_neighbors(g, draws[layer], cur_n.reshape(-1),
                                       cur_t.reshape(-1), n, bias=bias,
                                       eids=None if cur_e is None
                                       else cur_e.reshape(-1),
                                       sample_method=sample_method)
        nodes.append(nn_.reshape(b, -1))
        es.append(ne.reshape(b, -1))
        tss.append(nt.reshape(b, -1))
        cur_n, cur_e, cur_t = nn_, ne, nt
        if columns is not None and layer == 0:
            cur_n, cur_e, cur_t = (columns(x) for x in (nn_, ne, nt))
    return Subgraph(tuple(nodes), tuple(es), tuple(tss))


class Walks(NamedTuple):
    """Temporal motif walks (3 events, newest first), in the reference's
    layout: ``nodes[..., :] = (src3, tgt3, src2, tgt2, src1, tgt1)``,
    ``eids = (e3, e2, e1)``, ``ts = (t3, t2, t1)``, ``anony = (1, x, t)``;
    ``cat`` is the motif class 0..11 in ``CAT_ORDER``."""
    nodes: torch.Tensor    # [B, W, 6] int32
    eids: torch.Tensor     # [B, W, 3] int32
    ts: torch.Tensor       # [B, W, 3] float32
    anony: torch.Tensor    # [B, W, 3] int32
    cat: torch.Tensor      # [B, W] int32 in [0, 12)


class WalkDraws(NamedTuple):
    """The uniforms of one side's walks: ``u2`` [B * n1, n2] for the second
    event, ``u3`` [B * n1 * n2] for the third."""
    u2: torch.Tensor
    u3: torch.Tensor


def draw_walks(generator: torch.Generator, batch_size: int, n1: int, n2: int,
               device) -> WalkDraws:
    """One side's walk uniforms from ``generator``: u2, then u3."""
    q = batch_size * n1
    u2 = torch.rand((q, n2), generator=generator, device=device)
    return WalkDraws(u2, torch.rand((q * n2,), generator=generator,
                                    device=device))


# The canonical motif-class order of the reference's offline annotator.
CAT_ORDER = ["1,2,1", "1,2,2", "1,2,3", "1,2,0", "1,3,1", "1,3,3", "1,3,2",
             "1,3,0", "1,1,3", "1,1,2", "1,1,1", "1,1,0"]
# _CAT_LUT[x - 1][t] -> class id of the anonymous code (1, x, t)
_CAT_LUT = ((11, 10, 9, 8),    # x = 1: "1,1,0", "1,1,1", "1,1,2", "1,1,3"
            (3, 0, 1, 2),      # x = 2
            (7, 4, 6, 5))      # x = 3


def anony_to_cat(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    lut = torch.tensor(_CAT_LUT, dtype=torch.int32, device=x.device)
    return lut[(x - 1).clamp(0, 2).long(), t.clamp(0, 3).long()]


def find_k_walks(g, draws: WalkDraws, src: torch.Tensor, subgraph: Subgraph,
                 n1: int, n2: int) -> Walks:
    """Sample 3-event temporal motif walks: each of the ``n1`` first events
    (the support's hop 0) continues ``n2`` times, so ``n1 * n2`` walks per
    row. Event 2 is a uniform pick from the union of the source's and the
    first neighbour's histories before event 1 (``sample_union``); event 3
    is a uniform pick, from the histories of the pair the case analysis
    names, of the events that close the motif (``sample_masked``), and the
    anonymous code (1, x, t) records which motif it closed."""
    b = src.shape[0]
    tgt1, e1, t1 = subgraph.nodes[0], subgraph.eids[0], subgraph.ts[0]
    q1 = b * n1
    src32 = src.to(torch.int32)
    src_rep = src32[:, None].expand(b, n1).reshape(q1).contiguous()
    s2, u2, e2, t2 = sample_union(g, src_rep, tgt1.reshape(q1).contiguous(),
                                  e1.reshape(q1).contiguous(), draws.u2)
    w = n1 * n2
    s1_w = src32[:, None].expand(b, w)
    u1_w = tgt1.repeat_interleave(n2, dim=1)
    e1_w = e1.repeat_interleave(n2, dim=1)
    t1_w = t1.repeat_interleave(n2, dim=1)
    s2_w, u2_w, e2_w, t2_w = (x.reshape(b, w) for x in (s2, u2, e2, t2))

    # the case analysis of the reference's get_final_step
    qs1, qu1, qs2, qu2 = (x.reshape(-1) for x in (s1_w, u1_w, s2_w, u2_w))
    case1 = (qs1 == qs2) & (qu1 != qu2)
    case2 = (qu1 == qs2) & (qs1 != qu2) & ~case1
    case3 = ~(case1 | case2)
    node_a = torch.where(case1, qs1, qu1)
    va1 = torch.where(case1, qu1, qs1)      # case1: {u1, u2}; case2: {s1, u2}
    s3, u3, e3, t3, found = sample_masked(
        g, node_a, qu2.contiguous(), e2_w.reshape(-1).contiguous(), va1,
        qu2.contiguous(), va1, case3, draws.u3)

    # the anonymous code (1, x, t)
    x = torch.where(case1, 2, torch.where(case2, 3, 1)).to(torch.int32)

    def code(conds):
        out = torch.zeros_like(x)
        for cond, val in reversed(conds):
            out = torch.where(cond, val, out)
        return out

    t_c1 = code([((s3 == qs1) & (u3 == qu1), 1), ((s3 == qs1) & (u3 == qu2), 2),
                 ((s3 == qu1) & (u3 == qu2), 3)])
    t_c2 = code([((s3 == qu1) & (u3 == qs1), 1), ((s3 == qu1) & (u3 == qu2), 3),
                 ((s3 == qu2) & (u3 == qs1), 2)])
    t_c3 = code([((s3 == qs1) & (u3 != qu1), 3), ((s3 == qu1) & (u3 != qs1), 2),
                 ((s3 == qs1) & (u3 == qu1), 1), ((s3 == qu1) & (u3 == qs1), 1)])
    t_code = torch.where(case1, t_c1, torch.where(case2, t_c2, t_c3))
    t_code = torch.where(found, t_code, 0)
    anony = torch.stack([torch.ones_like(x), x, t_code], dim=-1)
    nodes = torch.stack([s3.reshape(b, w), u3.reshape(b, w), s2_w, u2_w,
                         s1_w, u1_w], dim=2)
    return Walks(nodes.to(torch.int32),
                 torch.stack([e3.reshape(b, w), e2_w, e1_w], dim=2)
                 .to(torch.int32),
                 torch.stack([t3.reshape(b, w), t2_w, t1_w], dim=2),
                 anony.reshape(b, w, 3), anony_to_cat(x, t_code).reshape(b, w))
