"""CSR temporal adjacency as tensors on a device.

Port of ``tempme_tpu/data/graph.py``: every event (u, v, e, t) adds an entry
to both endpoints' neighbour lists, each list sorted by timestamp (stable in
file order for ties) and flattened into ``(ngh_node, ngh_eid, ngh_ts)`` with
``off[n]:off[n+1]`` giving node n's slice. ``edge_ts`` maps an edge id to its
timestamp (0 for the padding id 0).

The secondary CSR ``bynb_*`` holds the same entries over the same ``off``
slices sorted by (node, neighbour, ts, file order): the entries of one
(node, neighbour) pair are contiguous and time-sorted, so "events of node v
with neighbour x strictly before t" is one double bisect. The walk
sampler's third event (``ops/kernels/sample_masked.py``) counts and picks
its candidates there.

The JAX package's dense ``[N, C]`` layout exists for the TPU's VMEM and is
left out: the CUDA sampling kernels read the CSR directly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.devices import resolve_device
from .events import EventStream


@dataclasses.dataclass(frozen=True)
class TemporalGraph:
    ngh_node: torch.Tensor   # [T] int32 neighbour node id per directed entry
    ngh_eid: torch.Tensor    # [T] int32 edge id per entry
    ngh_ts: torch.Tensor     # [T] float32 timestamp per entry (sorted per node)
    off: torch.Tensor        # [N+1] int32 CSR offsets
    edge_ts: torch.Tensor    # [E] float32 timestamp by edge id
    bynb_ngh: torch.Tensor   # [T] int32 the entries sorted by (node, ngh, ts)
    bynb_eid: torch.Tensor   # [T] int32
    bynb_ts: torch.Tensor    # [T] float32
    num_nodes: int
    num_edges: int
    max_degree: int

    @property
    def device(self) -> torch.device:
        return self.off.device


def build_temporal_graph(events: EventStream, num_nodes: int | None = None,
                         num_edges: int | None = None,
                         device=None) -> TemporalGraph:
    """Build the CSR on the host with numpy, then move it to ``device``
    (CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)
    if num_nodes is None:
        num_nodes = events.num_nodes
    if num_edges is None:
        num_edges = events.num_edges

    src = np.concatenate([events.src, events.dst]).astype(np.int64)
    ngh = np.concatenate([events.dst, events.src]).astype(np.int32)
    eid = np.concatenate([events.e_idx, events.e_idx]).astype(np.int32)
    ts = np.concatenate([events.ts, events.ts]).astype(np.float32)

    # stable sort by (node, ts): ties keep file order
    order = np.lexsort((np.arange(len(src)), ts, src))
    # secondary CSR: sorted by (node, neighbour, ts), ties in file order
    order2 = np.lexsort((np.arange(len(src)), ts, ngh.astype(np.int64), src))
    counts = np.bincount(src, minlength=num_nodes)
    off = np.zeros(num_nodes + 1, dtype=np.int32)
    np.cumsum(counts, out=off[1:])
    edge_ts = np.zeros(num_edges, dtype=np.float32)
    edge_ts[events.e_idx] = events.ts

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return TemporalGraph(
        ngh_node=put(ngh[order]), ngh_eid=put(eid[order]),
        ngh_ts=put(ts[order]), off=put(off), edge_ts=put(edge_ts),
        bynb_ngh=put(ngh[order2]), bynb_eid=put(eid[order2]),
        bynb_ts=put(ts[order2]),
        num_nodes=int(num_nodes), num_edges=int(num_edges),
        max_degree=int(counts.max()) if len(counts) else 0)
