"""Offline walk/subgraph cache: every event's supports and motif walks,
sampled once and stored as one compressed ``.npz`` per split.

Port of ``tempme_tpu/data/cache.py``, with the same keys, shapes and
dtypes, so a cache that either package writes is read by the other:

  subgraph_{side}_{0,1}   [N, 3 w] float32  nodes, eids, ts of hop 0 / 1
                                            (w = n, n**2)
  walks_{side}_nodes      [N, W, 6] int32   (W = n * n_walk_cont)
  walks_{side}_eids       [N, W, 3] int32
  walks_{side}_ts         [N, W, 3] float32
  walks_{side}_cat        [N, W] int32      motif class in [0, 12)
  walks_{side}_marginal   [N, W] float32    the class's share of the split
  edge_{side}             [N, W, 3, 3] float32  edge co-occurrence counts
  dst_fake                [N] int32         the negatives (the bgd anchors)
  class_distribution      [12] float32

for ``side`` in src, tgt, bgd. ``build_walk_cache`` samples on the
graph's device (``sample_rows`` 6 times, ``sample_union`` and
``sample_masked`` 3 times a batch); the negatives come from the numpy
``RandEdgeSampler`` on the host. Random draws enter as tensors: per batch
and side the 2 hops' uniforms and the walks' ``WalkDraws``, from a
``torch.Generator`` unless given (a test replays the JAX package's
``jax.random`` chain).

Node and edge ids are packed into the float32 ``subgraph_*`` columns,
which hold integers exactly only below 2**24; ``build_walk_cache``
refuses a graph with that many nodes or edges. ``cache_to_inputs``
refuses a cache whose widths do not match ``n_degree`` (a file's name
does not carry it).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops import sampler as S
from ..ops.segment import edge_cooccurrence_counts
from .events import EventStream, RandEdgeSampler

SIDES = ("src", "tgt", "bgd")
HOPS = 2                  # the cache's support depth
FLOAT32_EXACT_IDS = 2 ** 24


def draw_cache_batch(generator: torch.Generator, batch_size: int, n: int,
                     n_walk_cont: int, device) -> tuple:
    """One batch's draws from ``generator``: per side the hops' uniforms
    ([B, n] and [B * n, n]), then the side's ``WalkDraws``."""
    out = []
    for _ in SIDES:
        hops = tuple(torch.rand((batch_size * n ** layer, n),
                                generator=generator, device=device)
                     for layer in range(HOPS))
        out.append((hops, S.draw_walks(generator, batch_size, n,
                                       n_walk_cont, device)))
    return tuple(out)


def check_id_range(num_nodes: int, num_edges: int) -> None:
    if max(num_nodes, num_edges) >= FLOAT32_EXACT_IDS:
        raise ValueError(
            f"the walk cache packs node and edge ids into float32 columns, "
            f"exact only below 2**24; this graph has {num_nodes} nodes and "
            f"{num_edges} edges")


def sample_cache_batch(g, src, dst, bgd, ts, eidx, n_degree: int,
                       n_walk_cont: int, draws) -> dict:
    """The cache's arrays for one padded batch, on the graph's device:
    src and tgt cut at the batch's edges, bgd at its times."""
    out = {}
    for name, anchor, e, (hops, wd) in zip(SIDES, (src, dst, bgd),
                                           (eidx, eidx, None), draws):
        sub = S.find_k_hop(g, hops, anchor, ts, HOPS, n_degree, eids=e)
        walks = S.find_k_walks(g, wd, anchor, sub, n_degree, n_walk_cont)
        for h in range(HOPS):
            out[f"subgraph_{name}_{h}"] = torch.cat(
                [sub.nodes[h].float(), sub.eids[h].float(), sub.ts[h]], dim=1)
        out[f"walks_{name}_nodes"] = walks.nodes
        out[f"walks_{name}_eids"] = walks.eids
        out[f"walks_{name}_ts"] = walks.ts
        out[f"walks_{name}_cat"] = walks.cat
        out[f"edge_{name}"] = edge_cooccurrence_counts(walks.eids)
    return out


def build_walk_cache(g, events: EventStream, neg_sampler: RandEdgeSampler,
                     n_degree: int, n_walk_cont: int = 3,
                     batch_size: int = 128, seed: int = 0,
                     with_marginal: bool = True,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Sequence] = None) -> dict:
    """Sample supports and walks for every event of a split, ``batch_size``
    events at a time on the graph's device. Each batch is padded with
    zeros to ``batch_size`` and its negatives drawn from ``neg_sampler``;
    the outputs are cut to the batch on the host. ``draws[i]`` is batch
    i's per side (hop draws, ``WalkDraws``); without it every draw comes
    from ``generator`` (seeded with ``seed`` when None)."""
    check_id_range(g.num_nodes, int(g.edge_ts.shape[0]))
    dev = g.ngh_node.device
    if draws is None and generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
    n = len(events)
    chunks = []
    for i, s0 in enumerate(range(0, n, batch_size)):
        e0 = min(n, s0 + batch_size)
        pad = batch_size - (e0 - s0)
        sl = slice(s0, e0)

        def col(x, dtype):
            return torch.from_numpy(np.r_[x[sl], np.zeros(pad, dtype)]).to(dev)
        _, fake = neg_sampler.sample(batch_size)
        bd = draws[i] if draws is not None else draw_cache_batch(
            generator, batch_size, n_degree, n_walk_cont, dev)
        out = sample_cache_batch(
            g, col(events.src, np.int32), col(events.dst, np.int32),
            torch.from_numpy(np.asarray(fake, np.int32)).to(dev),
            col(events.ts, np.float32), col(events.e_idx, np.int32),
            n_degree, n_walk_cont, bd)
        out = {k: v.cpu().numpy()[:e0 - s0] for k, v in out.items()}
        out["dst_fake"] = np.asarray(fake)[:e0 - s0]
        chunks.append(out)
    cache = {k: np.concatenate([c[k] for c in chunks], axis=0)
             for k in chunks[0]}
    if with_marginal:
        # the motif classes' shares over the whole split
        cats = np.concatenate([cache[f"walks_{s}_cat"].ravel()
                               for s in SIDES])
        dist = np.bincount(cats, minlength=12) / max(len(cats), 1)
        cache["class_distribution"] = dist.astype(np.float32)
        for s in SIDES:
            cache[f"walks_{s}_marginal"] = dist[
                cache[f"walks_{s}_cat"]].astype(np.float32)
    return cache


def pack_walks_14(cache: dict, side: str) -> np.ndarray:
    """The reference's 14-wide walk rows: 6 nodes, 3 eids, 3 ts, the
    class and its marginal."""
    return np.concatenate([
        cache[f"walks_{side}_nodes"].astype(np.float32),
        cache[f"walks_{side}_eids"].astype(np.float32),
        cache[f"walks_{side}_ts"].astype(np.float32),
        cache[f"walks_{side}_cat"][..., None].astype(np.float32),
        cache[f"walks_{side}_marginal"][..., None],
    ], axis=-1)


def check_cache_widths(cache: dict, n_degree: int,
                       n_walk_cont: int = 3) -> None:
    """Raise unless the cache was sampled at ``n_degree`` neighbours and
    ``n_walk_cont`` continuations (a cache file's name carries neither)."""
    want = {f"subgraph_{s}_{h}": 3 * n_degree ** (h + 1)
            for s in SIDES for h in range(HOPS)}
    want.update({f"walks_{s}_nodes": n_degree * n_walk_cont for s in SIDES})
    got = {k: cache[k].shape[1] for k in want}
    if got != want:
        bad = {k: v for k, v in got.items() if v != want[k]}
        raise ValueError(
            f"the walk cache's widths {bad} do not match n_degree "
            f"{n_degree} (want {[want[k] for k in bad]}); it was built at "
            f"another n_degree: delete it or point --cache_dir elsewhere")


def cache_to_inputs(cache: dict, idx: np.ndarray, n_degree: int, device):
    """Rows ``idx`` of a cached split as the online sampler's outputs on
    ``device``: ``(bgd, (Subgraph x 3), (WalkInputs x 3))``, what the
    explainer's train and eval steps take in place of their sampling."""
    from ..explain.tempme import WalkInputs
    check_cache_widths(cache, n_degree)

    def t(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x)).to(
            device=device, dtype=dtype)

    def sub(side):
        nodes, eids, ts = [], [], []
        for h in range(HOPS):
            w = n_degree ** (h + 1)
            arr = cache[f"subgraph_{side}_{h}"][idx]
            nodes.append(t(arr[:, :w], torch.int32))
            eids.append(t(arr[:, w:2 * w], torch.int32))
            ts.append(t(arr[:, 2 * w:], torch.float32))
        return S.Subgraph(tuple(nodes), tuple(eids), tuple(ts))

    def wlk(side):
        return WalkInputs(
            nodes=t(cache[f"walks_{side}_nodes"][idx], torch.int32),
            eids=t(cache[f"walks_{side}_eids"][idx], torch.int32),
            ts=t(cache[f"walks_{side}_ts"][idx], torch.float32),
            cat=t(cache[f"walks_{side}_cat"][idx], torch.int32),
            edge_count=t(cache[f"edge_{side}"][idx], torch.float32))

    bgd = t(cache["dst_fake"][idx], torch.int32)
    return (bgd, tuple(sub(s) for s in SIDES), tuple(wlk(s) for s in SIDES))


def save_cache(path: str, cache: dict) -> None:
    np.savez_compressed(path, **cache)


def load_cache(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
