"""Dataset subsampling tools (the reference's sampling/sample_dataset.py
and sampling/sample_uslegis.py).

The port's own copy of ``tempme_tpu/data/subsample.py``: numpy only, so
the same seed gives the same outputs bit for bit.

* ``temporal_stratified_sample`` — Enron-style: split the time range into
  windows, sample a fixed fraction of edges per window (preserves temporal
  structure), drop low-degree nodes, remap node ids densely (1-based, id 0
  reserved), subset features (sample_dataset.py:23-154).
* ``session_stratified_sample`` — USLegis-style: datasets with discrete
  session timestamps; node importance = 0.6 * session-coverage +
  0.4 * degree-percentile, keep the top ``key_frac`` "key" nodes plus a
  random draw of others, then keep all edges between kept nodes
  (sample_uslegis.py:30,86,368).
* ``analyze`` — dataset statistics (sample_dataset.py:157).
"""
from __future__ import annotations

import os
import os.path as osp
from typing import Dict

import numpy as np

from .events import EventStream


def analyze(events: EventStream) -> Dict[str, float]:
    nodes = np.unique(np.r_[events.src, events.dst])
    deg = np.bincount(events.src, minlength=events.num_nodes) + \
        np.bincount(events.dst, minlength=events.num_nodes)
    deg = deg[nodes]
    return dict(
        num_events=len(events),
        num_nodes=len(nodes),
        num_sessions=len(np.unique(events.ts)),
        t_min=float(events.ts.min()) if len(events) else 0.0,
        t_max=float(events.ts.max()) if len(events) else 0.0,
        mean_degree=float(deg.mean()) if len(deg) else 0.0,
        max_degree=int(deg.max()) if len(deg) else 0,
    )


def _remap(events: EventStream, keep_edge_mask: np.ndarray,
           node_feat: np.ndarray, edge_feat: np.ndarray,
           min_degree: int = 0):
    """Apply an edge mask, optionally drop low-degree nodes, remap node ids to
    a dense 1-based range and edge ids to 1..E, subset feature rows."""
    ev = events.select(keep_edge_mask)
    if min_degree > 0:
        while True:
            deg = np.bincount(ev.src, minlength=events.num_nodes) + \
                np.bincount(ev.dst, minlength=events.num_nodes)
            bad = (deg > 0) & (deg < min_degree)
            if not bad.any():
                break
            keep = ~(bad[ev.src] | bad[ev.dst])
            if keep.all():
                break
            ev = ev.select(keep)

    old_nodes = np.unique(np.r_[ev.src, ev.dst])
    node_map = np.zeros(events.num_nodes, np.int32)
    node_map[old_nodes] = np.arange(1, len(old_nodes) + 1, dtype=np.int32)
    new_src = node_map[ev.src]
    new_dst = node_map[ev.dst]
    order = np.argsort(ev.ts, kind="mergesort")
    new_e_idx = np.arange(1, len(ev) + 1, dtype=np.int32)

    new_events = EventStream(new_src[order], new_dst[order], ev.ts[order],
                             ev.label[order], new_e_idx)
    new_node_feat = np.zeros((len(old_nodes) + 1, node_feat.shape[1]),
                             np.float32)
    new_node_feat[1:] = node_feat[old_nodes]
    new_edge_feat = np.zeros((len(ev) + 1, edge_feat.shape[1]), np.float32)
    new_edge_feat[1:] = edge_feat[ev.e_idx[order]]
    return new_events, new_node_feat, new_edge_feat, node_map


def temporal_stratified_sample(events: EventStream, node_feat: np.ndarray,
                               edge_feat: np.ndarray,
                               edge_sample_ratio: float = 0.15,
                               num_windows: int = 20,
                               min_degree: int = 2,
                               seed: int = 42):
    rng = np.random.RandomState(seed)
    ts = events.ts
    bounds = np.quantile(ts, np.linspace(0, 1, num_windows + 1))
    keep = np.zeros(len(events), bool)
    for w in range(num_windows):
        lo, hi = bounds[w], bounds[w + 1]
        in_w = (ts >= lo) & (ts <= hi if w == num_windows - 1 else ts < hi)
        idx = np.where(in_w)[0]
        k = max(1, int(round(edge_sample_ratio * len(idx)))) if len(idx) else 0
        if k:
            keep[rng.choice(idx, size=k, replace=False)] = True
    return _remap(events, keep, node_feat, edge_feat, min_degree)


def session_stratified_sample(events: EventStream, node_feat: np.ndarray,
                              edge_feat: np.ndarray,
                              node_keep_ratio: float = 0.5,
                              key_frac: float = 0.7,
                              coverage_weight: float = 0.6,
                              degree_weight: float = 0.4,
                              seed: int = 42):
    rng = np.random.RandomState(seed)
    n = events.num_nodes
    sessions = np.unique(events.ts)
    n_sessions = len(sessions)
    sess_of = np.searchsorted(sessions, events.ts)

    cover = np.zeros((n,), np.float64)
    for node_arr in (events.src, events.dst):
        pairs = np.unique(np.stack([node_arr, sess_of]), axis=1)
        np.add.at(cover, pairs[0], 1.0)
    cover = np.minimum(cover, n_sessions) / max(n_sessions, 1)
    deg = (np.bincount(events.src, minlength=n)
           + np.bincount(events.dst, minlength=n)).astype(np.float64)
    active = deg > 0
    deg_pct = np.zeros(n)
    if active.any():
        ranks = deg[active].argsort().argsort()
        deg_pct[active] = ranks / max(len(ranks) - 1, 1)
    importance = coverage_weight * cover + degree_weight * deg_pct

    n_keep = int(round(node_keep_ratio * active.sum()))
    n_key = int(round(key_frac * n_keep))
    order = np.argsort(-importance)
    order = order[active[order]]
    key_nodes = order[:n_key]
    rest = order[n_key:]
    other = rng.choice(rest, size=min(n_keep - n_key, len(rest)),
                       replace=False) if n_keep > n_key and len(rest) else \
        np.array([], np.int64)
    kept = np.zeros(n, bool)
    kept[key_nodes] = True
    kept[other.astype(np.int64)] = True
    keep_edges = kept[events.src] & kept[events.dst]
    return _remap(events, keep_edges, node_feat, edge_feat)


def save_ml_dataset(out_dir: str, name: str, events: EventStream,
                    node_feat: np.ndarray, edge_feat: np.ndarray) -> None:
    """Write the ml_{name}.csv / .npy / _node.npy layout."""
    os.makedirs(out_dir, exist_ok=True)
    with open(osp.join(out_dir, f"ml_{name}.csv"), "w") as f:
        f.write(",u,i,ts,label,idx\n")
        for k in range(len(events)):
            f.write(f"{k},{events.src[k]},{events.dst[k]},{events.ts[k]},"
                    f"{events.label[k]},{events.e_idx[k]}\n")
    np.save(osp.join(out_dir, f"ml_{name}.npy"), edge_feat[1:])
    np.save(osp.join(out_dir, f"ml_{name}_node.npy"), node_feat)
