"""Synthetic event streams with published dataset shapes.

The port's copy of the generators in the root ``bench.py``
(``make_enron_shaped``, ``LARGE_SHAPES``, ``make_large_shaped``), with the
same seeds, so both packages see the same streams.
"""
from __future__ import annotations

import numpy as np

from .events import EventStream


def make_enron_shaped():
    """Full Enron's shape: 125,235 events / 184 nodes / 32-dim edge and
    node features. Returns ``(events, node_feat, edge_feat)``; row 0 of both
    feature tables is the zero padding row."""
    num_events, num_nodes, de, dn = 125_235, 184, 32, 32
    r = np.random.RandomState(7)
    src = r.randint(1, num_nodes + 1, num_events).astype(np.int32)
    dst = r.randint(1, num_nodes + 1, num_events).astype(np.int32)
    ts = np.sort(r.rand(num_events).astype(np.float32) * 1e6)
    ev = EventStream(src, dst, ts, np.zeros(num_events, np.float32),
                     np.arange(1, num_events + 1, dtype=np.int32))
    node_feat = np.r_[np.zeros((1, dn)),
                      r.randn(num_nodes, dn)].astype(np.float32)
    edge_feat = np.r_[np.zeros((1, de)),
                      r.randn(num_events, de)].astype(np.float32)
    return ev, node_feat, edge_feat


# JODIE datasets' published node/event counts and feature widths.
LARGE_SHAPES = {
    # 9,227 nodes / 157,474 events / 172-dim features, n_degree=20
    "wikipedia": dict(num_events=157_474, num_users=8_227, num_items=1_000,
                      feat=172, n_degree=20),
    # 10,984 nodes / 672,447 events / 172-dim features, n_degree=20
    "reddit": dict(num_events=672_447, num_users=10_000, num_items=984,
                   feat=172, n_degree=20),
}


def make_large_shaped(name, zipf=1.1, seed=11):
    """Bipartite user->item stream shaped like the JODIE dataset ``name``:
    item popularity ~ Zipf(zipf), user activity a milder power law. Node
    ids: 1..num_users users, then items. Returns
    ``(events, node_feat, edge_feat)``."""
    cfg = LARGE_SHAPES[name]
    ne, nu, ni, d = (cfg["num_events"], cfg["num_users"], cfg["num_items"],
                     cfg["feat"])
    r = np.random.RandomState(seed)
    p_item = 1.0 / np.arange(1, ni + 1) ** zipf
    p_item /= p_item.sum()
    p_user = 1.0 / np.arange(1, nu + 1) ** 0.6
    p_user /= p_user.sum()
    src = (1 + r.choice(nu, ne, p=p_user)).astype(np.int32)
    dst = (1 + nu + r.choice(ni, ne, p=p_item)).astype(np.int32)
    ts = np.sort(r.rand(ne).astype(np.float32) * 1e6)
    ev = EventStream(src, dst, ts, np.zeros(ne, np.float32),
                     np.arange(1, ne + 1, dtype=np.int32))
    node_feat = np.r_[np.zeros((1, d)), r.randn(nu + ni, d)].astype(np.float32)
    edge_feat = np.r_[np.zeros((1, d)), r.randn(ne, d)].astype(np.float32)
    return ev, node_feat, edge_feat
