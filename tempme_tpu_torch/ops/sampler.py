"""Temporal neighbour sampling (uniform mode) and the k-hop support.

Port of ``tempme_tpu/ops/sampler.py:98-225,264-289``. Random draws enter as
tensors so that a test can replay ``jax.random`` draws in JAX's split order:
``find_k_hop`` takes one ``[B * n**l, n]`` uniform tensor per hop ``l``,
which is what ``jax.random.uniform(sub, (q, n))`` gives after
``key, sub = split(key)`` per hop. On the card the draws come from a
``torch.Generator`` (``train/loops.py::draw_support``).

The sampling itself is the ``sample_rows`` kernel (``ops/kernels``): the
bisect, the picks and the three gathers in one launch per hop. Its plain
version holds ``cut_by_time``, ``cut_by_edge`` and ``uniform_pick`` (JAX's
``_uniform_pick``).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from .kernels.sample_rows import sample_rows


class Subgraph(NamedTuple):
    """k-hop temporal support: hop l arrays have width n**(l+1)."""
    nodes: Tuple[torch.Tensor, ...]   # each [B, n**(l+1)] int32
    eids: Tuple[torch.Tensor, ...]    # each [B, n**(l+1)] int32
    ts: Tuple[torch.Tensor, ...]      # each [B, n**(l+1)] float32


def sample_neighbors(g, u: torch.Tensor, nodes: torch.Tensor,
                     times: torch.Tensor, n: int, bias: float = 0.0,
                     eids: torch.Tensor | None = None,
                     sample_method: str = "multinomial"):
    """k=1 temporal neighbour sampling -> ([Q,n] node, [Q,n] eid, [Q,n] ts),
    uniform with replacement, sorted by position, zero-padded. ``u`` holds
    the [Q, n] uniforms. With ``eids`` the history is cut at each edge's
    timestamp (e-path)."""
    if sample_method != "multinomial" or bias != 0.0:
        raise NotImplementedError(
            "exp-decay and binary sampling are not ported yet "
            "(ROADMAP item A2)")
    if u.shape != (nodes.shape[0], n):
        raise ValueError(f"u must be [{nodes.shape[0]}, {n}], got "
                         f"{tuple(u.shape)}")
    return sample_rows(g, nodes.to(torch.int32), times, u,
                       None if eids is None else eids.to(torch.int32))


def find_k_hop(g, draws: Sequence[torch.Tensor], src: torch.Tensor,
               times: torch.Tensor, k: int, n: int,
               eids: torch.Tensor | None = None) -> Subgraph:
    """Recursive k-hop support, widths n, n**2, ..., n**k. Hop 0 samples
    each (src, t) from its strict history (cut at ``eids`` when given);
    hop l > 0 samples each previous-hop event's endpoint with the history
    cut at that event's edge. ``draws[l]`` is hop l's [B * n**l, n] uniform
    tensor."""
    b = src.shape[0]
    nodes, es, tss = [], [], []
    cur_n, cur_t, cur_e = src, times, eids
    for layer in range(k):
        nn_, ne, nt = sample_neighbors(g, draws[layer], cur_n.reshape(-1),
                                       cur_t.reshape(-1), n,
                                       eids=None if cur_e is None
                                       else cur_e.reshape(-1))
        nodes.append(nn_.reshape(b, -1))
        es.append(ne.reshape(b, -1))
        tss.append(nt.reshape(b, -1))
        cur_n, cur_e, cur_t = nn_, ne, nt
    return Subgraph(tuple(nodes), tuple(es), tuple(tss))
