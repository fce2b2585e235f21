"""Event-stream container and temporal split logic (numpy).

The port's own copy of ``tempme_tpu/data/events.py``: the same struct of
arrays ``(src, dst, ts, label, e_idx)``, the ``ml_{name}`` file layout, the
70/15/15 quantile time split with the seed-2023 masked "new node" set over a
sorted candidate list, the uniform negative sampler, the shuffled "null
graph" of the explainer's motif prior and the per-side inter-event gap
statistics. Pure numpy, so the outputs equal the JAX
package's bit for bit.
"""
from __future__ import annotations

import dataclasses
import os.path as osp
import random
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class EventStream:
    """A continuous-time event stream (struct of arrays)."""
    src: np.ndarray        # [E] int32 source node ids
    dst: np.ndarray        # [E] int32 destination node ids
    ts: np.ndarray         # [E] float32 timestamps (non-decreasing in file order)
    label: np.ndarray      # [E] float32 event labels
    e_idx: np.ndarray      # [E] int32 1-based edge ids (0 reserved for padding)

    def __len__(self) -> int:
        return len(self.src)

    @property
    def num_nodes(self) -> int:
        """max node id + 1 (node id 0 is reserved as padding in all models)."""
        if len(self.src) == 0:
            return 1
        return int(max(self.src.max(), self.dst.max())) + 1

    @property
    def num_edges(self) -> int:
        """max edge id + 1 (edge id 0 is reserved as padding)."""
        if len(self.e_idx) == 0:
            return 1
        return int(self.e_idx.max()) + 1

    def select(self, mask: np.ndarray) -> "EventStream":
        return EventStream(self.src[mask], self.dst[mask], self.ts[mask],
                           self.label[mask], self.e_idx[mask])


@dataclasses.dataclass(frozen=True)
class DatasetSplits:
    full: EventStream
    train: EventStream
    val: EventStream
    test: EventStream
    val_time: float
    test_time: float
    mask_node_set: frozenset
    node_feat: np.ndarray   # [N, Dn] float32, row 0 must be a padding row
    edge_feat: np.ndarray   # [E+1, De] float32, row 0 must be a padding row


def load_csv_events(csv_path: str) -> EventStream:
    """Load ``ml_{name}.csv`` (columns: index,u,i,ts,label,idx).

    Pure-numpy parser (no pandas dependency on the hot path).
    """
    with open(csv_path, "r") as f:
        header = f.readline().strip().split(",")
        cols = {name: k for k, name in enumerate(header)}
        raw = np.loadtxt(f, delimiter=",", dtype=np.float64, ndmin=2)
    u = raw[:, cols["u"]].astype(np.int32)
    i = raw[:, cols["i"]].astype(np.int32)
    ts = raw[:, cols["ts"]].astype(np.float32)
    label = raw[:, cols["label"]].astype(np.float32)
    e_idx = raw[:, cols["idx"]].astype(np.int32)
    return EventStream(u, i, ts, label, e_idx)


def _pad_feature_row0(feat: np.ndarray) -> np.ndarray:
    """The reference relies on Embedding(padding_idx=0) zeroing row 0
    (TGAT/TGAT.py:413-414). We enforce an explicit zero row 0 instead."""
    feat = np.asarray(feat, dtype=np.float32)
    if feat.ndim == 1:
        feat = feat[:, None]
    feat = feat.copy()
    feat[0] = 0.0
    return feat


def load_dataset(name: str, data_dir: str) -> "DatasetSplits":
    events = load_csv_events(osp.join(data_dir, f"ml_{name}.csv"))
    edge_feat = np.load(osp.join(data_dir, f"ml_{name}.npy"))
    node_feat = np.load(osp.join(data_dir, f"ml_{name}_node.npy"))
    # Edge features are indexed by 1-based e_idx in the reference; the .npy may
    # have either E or E+1 rows. Normalize to [num_edges, De] with zero row 0.
    num_edges = events.num_edges
    edge_feat = np.asarray(edge_feat, dtype=np.float32)
    if edge_feat.ndim == 1:
        edge_feat = edge_feat[:, None]
    if edge_feat.shape[0] == num_edges - 1:
        edge_feat = np.concatenate(
            [np.zeros((1, edge_feat.shape[1]), np.float32), edge_feat], axis=0)
    node_feat = np.asarray(node_feat, dtype=np.float32)
    if node_feat.ndim == 1:
        node_feat = node_feat[:, None]
    num_nodes = events.num_nodes
    if node_feat.shape[0] < num_nodes:
        pad = np.zeros((num_nodes - node_feat.shape[0], node_feat.shape[1]),
                       np.float32)
        node_feat = np.concatenate([node_feat, pad], axis=0)
    return split_events(events, node_feat=_pad_feature_row0(node_feat),
                        edge_feat=_pad_feature_row0(edge_feat))


def split_events(events: EventStream,
                 node_feat: np.ndarray,
                 edge_feat: np.ndarray,
                 val_quantile: float = 0.70,
                 test_quantile: float = 0.85,
                 mask_frac: float = 0.10,
                 split_seed: int = 2023) -> DatasetSplits:
    """Quantile time split with masked "new" nodes (learn_base.py:90-138)."""
    ts = events.ts.astype(np.float64)
    val_time, test_time = np.quantile(ts, [val_quantile, test_quantile])

    total_node_set = set(np.unique(np.hstack([events.src, events.dst])).tolist())
    num_total_unique_nodes = len(total_node_set)

    rng = random.Random(split_seed)
    # The reference seeds the *global* random module; we use an instance with the
    # same algorithm. Node set iteration order over python ints is value-stable,
    # so sorted() gives identical candidate ordering to the reference's
    # list(set(...)) for the small-int id ranges used here is NOT guaranteed --
    # we therefore sort for determinism (deviation: the reference depends on
    # CPython set iteration order; ours is explicitly deterministic).
    after_val = sorted(set(events.src[ts > val_time].tolist())
                       | set(events.dst[ts > val_time].tolist()))
    k = int(mask_frac * num_total_unique_nodes)
    mask_node_set = frozenset(rng.sample(after_val, k)) if k > 0 else frozenset()

    mask_arr = np.zeros(events.num_nodes, dtype=bool)
    for n in mask_node_set:
        mask_arr[n] = True
    mask_src = mask_arr[events.src]
    mask_dst = mask_arr[events.dst]
    none_node_flag = (~mask_src) & (~mask_dst)

    valid_train = (ts <= val_time) & none_node_flag
    valid_val = (ts <= test_time) & (ts > val_time)
    valid_test = ts > test_time

    return DatasetSplits(
        full=events,
        train=events.select(valid_train),
        val=events.select(valid_val),
        test=events.select(valid_test),
        val_time=float(val_time),
        test_time=float(test_time),
        mask_node_set=mask_node_set,
        node_feat=node_feat,
        edge_feat=edge_feat,
    )


class RandEdgeSampler:
    """Uniform negative destination sampler (utils/batch_loader.py:32-42)."""

    def __init__(self, src_lists, dst_lists, seed: Optional[int] = None):
        self.src_list = np.unique(np.concatenate([np.asarray(x) for x in src_lists]))
        self.dst_list = np.unique(np.concatenate([np.asarray(x) for x in dst_lists]))
        self._rng = np.random.RandomState(seed)

    def sample(self, size: int):
        src_index = self._rng.randint(0, len(self.src_list), size)
        dst_index = self._rng.randint(0, len(self.dst_list), size)
        return self.src_list[src_index], self.dst_list[dst_index]


def shuffled_events(events: EventStream,
                    seed: Optional[int] = None) -> EventStream:
    """Permute (src, dst, label) against (ts, e_idx): the "null graph" of
    the explainer's motif prior (``explain/null_model.py``)."""
    perm = np.random.RandomState(seed).permutation(len(events))
    return EventStream(events.src[perm], events.dst[perm], events.ts,
                       events.label[perm], events.e_idx)


def compute_time_statistics(events: EventStream
                            ) -> Tuple[Tuple[float, float], Tuple[float, float]]:
    """Per-side mean/std of inter-event gaps, consumed by the Jodie-style
    "time" embedding's normalized time diffs (reference TGN/tgn.py:20-21,
    131-140; the reference leaves them at (0,1) defaults because its driver
    never passes them — we compute the real statistics).

    For each event, the gap is ``ts - last_ts[node]`` with ``last_ts``
    initialised to 0, tracked separately for source and destination roles.
    Returns ``((mean_src, mean_dst), (std_src, std_dst))``.
    """
    diffs = []
    ts = events.ts.astype(np.float64)
    for nodes in (events.src, events.dst):
        # vectorized per-node gap computation: stable-sort events by node,
        # diff timestamps within each node's group (first event per node
        # diffs against 0, the reference's last_ts init)
        order = np.argsort(nodes, kind="stable")
        sn, st = nodes[order], ts[order]
        d_sorted = np.empty(len(st), np.float64)
        if len(st):
            first = np.r_[True, sn[1:] != sn[:-1]]
            d_sorted[first] = st[first]            # gap vs last_ts = 0
            rest = np.flatnonzero(~first)
            d_sorted[rest] = st[rest] - st[rest - 1]
        d = np.empty(len(st), np.float64)
        d[order] = d_sorted
        diffs.append(d)
    return ((float(diffs[0].mean()), float(diffs[1].mean())),
            (float(max(diffs[0].std(), 1e-9)), float(max(diffs[1].std(), 1e-9))))
