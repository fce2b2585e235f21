"""Null-model motif prior: the 12-class motif distribution of a shuffled
graph.

Port of ``tempme_tpu/explain/null_model.py``: reload the stream with
(src, dst) permuted against (ts, e_idx), sample 50 batches of 10 test
events' motif walks (``n1 = n_degree``, ``n2 = 1``) on the shuffled full
graph and normalise the class counts, in ``CAT_ORDER`` (the order the KL
pairs with the empirical means). The walks run on the device through the
sampling kernels. Each batch's uniforms come in as tensors
(``draw_null_batch`` makes them from a ``torch.Generator`` seeded with
``seed``), so a test can hand in the ones JAX draws from its keys and get
the JAX package's counts exactly.
"""
from __future__ import annotations

import os
import os.path as osp
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..data.events import EventStream, shuffled_events, split_events
from ..data.graph import build_temporal_graph
from ..ops import sampler as S
from ..utils.devices import resolve_device

# one batch's uniforms: per side (src, dst, background) the two hop levels'
# and the walks', in the order the JAX estimator splits its six keys
NullBatchDraws = Tuple[Tuple[Tuple[torch.Tensor, torch.Tensor],
                             S.WalkDraws], ...]


def draw_null_batch(generator: torch.Generator, batch_size: int,
                    n_degree: int, device) -> NullBatchDraws:
    """One batch's uniforms from ``generator``: for each of the three
    sides, hop 0 ``[B, n]``, hop 1 ``[B * n, n]``, then the walks'."""
    def side():
        hops = tuple(torch.rand((batch_size * n_degree ** layer, n_degree),
                                generator=generator, device=device)
                     for layer in range(2))
        return hops, S.draw_walks(generator, batch_size, n_degree, 1, device)
    return tuple(side() for _ in range(3))


def estimate_null_distribution(events: EventStream, n_degree: int,
                               node_feat: np.ndarray, edge_feat: np.ndarray,
                               num_batches: int = 50, batch_size: int = 10,
                               seed: int = 0, device=None,
                               draw: Optional[Callable[[], NullBatchDraws]]
                               = None) -> np.ndarray:
    """The [12] motif-class probability vector in ``CAT_ORDER``. ``draw``
    returns the next batch's uniforms (``draw_null_batch`` from a generator
    seeded with ``seed`` by default)."""
    dev = resolve_device(device)
    shuf = shuffled_events(events, seed=seed)
    splits = split_events(shuf, node_feat, edge_feat)
    g = build_temporal_graph(shuf, events.num_nodes, events.num_edges,
                             device=dev)
    test = splits.test
    if draw is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

        def draw():
            return draw_null_batch(gen, batch_size, n_degree, dev)
    rng = np.random.RandomState(seed)
    dst_pool = np.unique(np.concatenate([test.src, test.dst,
                                         splits.train.dst]))
    counts = torch.zeros(12, dtype=torch.int64, device=dev)
    total = 0
    n = len(test)
    for b in range(num_batches):
        s = b * batch_size
        if s + batch_size > n:
            break

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        src, dst = put(test.src[s:s + batch_size]), put(test.dst[s:s + batch_size])
        bgd = put(dst_pool[rng.randint(0, len(dst_pool), batch_size)])
        ts = put(test.ts[s:s + batch_size])
        eidx = put(test.e_idx[s:s + batch_size])
        sides = ((src, eidx), (dst, eidx), (bgd, None))
        for (anchor, e), (hops, walk_draws) in zip(sides, draw()):
            sub = S.find_k_hop(g, hops, anchor, ts, 2, n_degree, eids=e)
            walks = S.find_k_walks(g, walk_draws, anchor, sub, n_degree, 1)
            counts += torch.bincount(walks.cat.reshape(-1).long(),
                                     minlength=12)
            total += walks.cat.numel()
    if total == 0:
        return np.full(12, 1.0 / 12, np.float32)
    return (counts.cpu().numpy() / total).astype(np.float32)


def get_null_distribution(data_name: str, events: EventStream, n_degree: int,
                          node_feat: np.ndarray, edge_feat: np.ndarray,
                          cache_dir: str, seed: int = 0, device=None,
                          draw: Optional[Callable[[], NullBatchDraws]] = None
                          ) -> np.ndarray:
    """The cached prior: ``null_{data}_n{n_degree}_s{seed}.npy`` under
    ``cache_dir``, estimated on first use (a dataset-level constant);
    ``draw`` as in ``estimate_null_distribution``."""
    path = osp.join(cache_dir, f"null_{data_name}_n{n_degree}_s{seed}.npy")
    if osp.exists(path):
        return np.load(path).astype(np.float32)
    dist = estimate_null_distribution(events, n_degree, node_feat, edge_feat,
                                      seed=seed, device=device, draw=draw)
    os.makedirs(cache_dir, exist_ok=True)
    np.save(path, dist)
    return dist
