"""k=1 temporal neighbour sampling: CUDA kernel wrapper and plain version.

Replaces the TPU kernel ``tempme_tpu/ops/pallas/sample_kernel.py``
(``_sample_rows_kernel``, entry ``sample_rows``); the kernel is
``csrc/sample_rows.cu``, whose note gives its design and its bound (bytes).

For each query (node, cut time, optional edge id) it draws ``n`` picks from
the node's events strictly before the cut, ``clip(floor(u * cut), 0,
cut - 1)``, sorted, and returns (neighbour, edge id, timestamp) at the picks;
all zeros where the cut is empty. With edge ids the cut time is the edge's
timestamp and node 0 or edge 0 forces an empty row. Outputs are bit-identical
to the JAX CSR sampler given the same uniforms.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build


def cut_by_time(g, nodes, times):
    """(start, cut): each node's CSR slice start and its count of events
    strictly before ``times`` (bisect_left), by the JAX package's
    fixed-iteration vectorised bisect. int64 [Q] each."""
    nodes = nodes.long().clamp(0, g.num_nodes - 1)
    lo = g.off[nodes].long()
    hi = g.off[nodes + 1].long()
    start = lo
    last = max(g.ngh_ts.shape[0] - 1, 0)
    iters = max(1, int(math.ceil(math.log2(max(2, g.max_degree + 1)))) + 1)
    for _ in range(iters):
        active = lo < hi
        mid = (lo + hi) // 2
        below = g.ngh_ts[mid.clamp(max=last)] < times
        lo = torch.where(active & below, mid + 1, lo)
        hi = torch.where(active & ~below, mid, hi)
    return start, lo - start


def cut_by_edge(g, nodes, eids):
    """The e-path cut: events strictly before edge ``eids``' timestamp;
    node 0 or edge 0 (padding) forces an empty prefix."""
    eids = eids.long().clamp(0, g.num_edges - 1)
    start, cut = cut_by_time(g, nodes, g.edge_ts[eids])
    return start, torch.where((nodes == 0) | (eids == 0), 0, cut)


def cut_history(g, nodes, times, eids=None):
    """(start, cut) of each query's history: before ``times``, or with
    ``eids`` before each edge's timestamp (``cut_by_edge``)."""
    if eids is None:
        return cut_by_time(g, nodes, times)
    return cut_by_edge(g, nodes, eids)


def uniform_pick(u, cut):
    """[Q, n] uniforms and [Q] cuts -> [Q, n] sorted picks in [0, cut)
    (0 where cut == 0), with the JAX package's float32 arithmetic."""
    cut = cut[:, None]
    idx = torch.floor(u * cut.to(torch.float32)).to(torch.int64)
    idx = torch.minimum(idx.clamp(min=0), (cut - 1).clamp(min=0))
    return torch.sort(idx, dim=1).values


def sample_rows_plain(g, nodes, times, u, eids=None):
    """The plain PyTorch version: ([Q,n] int32 node, [Q,n] int32 eid,
    [Q,n] float32 ts)."""
    start, cut = cut_history(g, nodes, times, eids)
    idx = uniform_pick(u, cut)
    pos = (start[:, None] + idx).clamp(max=max(g.ngh_ts.shape[0] - 1, 0))
    valid = cut[:, None] > 0
    zero = torch.zeros((), dtype=torch.int32, device=u.device)
    return (torch.where(valid, g.ngh_node[pos], zero),
            torch.where(valid, g.ngh_eid[pos], zero),
            torch.where(valid, g.ngh_ts[pos], zero.to(torch.float32)))


def _check(g, nodes, times, u, eids):
    if u.dim() != 2 or u.dtype != torch.float32:
        raise ValueError("u must be a float32 [Q, n] tensor")
    q = u.shape[0]
    if nodes.shape != (q,) or nodes.dtype != torch.int32:
        raise ValueError("nodes must be an int32 [Q] tensor")
    if eids is not None:
        if eids.shape != (q,) or eids.dtype != torch.int32:
            raise ValueError("eids must be an int32 [Q] tensor")
    elif times is None or times.shape != (q,) or times.dtype != torch.float32:
        raise ValueError("times must be a float32 [Q] tensor")
    for t in (nodes, times, u, eids):
        if t is not None and t.device != g.device:
            raise ValueError(f"tensor on {t.device}, graph on {g.device}")
        if t is not None and g.device.type == "cuda" and not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")


def sample_rows(g, nodes, times, u, eids=None):
    """Sample ``n = u.shape[1]`` neighbours per query. ``nodes`` int32 [Q],
    ``times`` float32 [Q] (ignored when ``eids`` is given), ``u`` float32
    [Q, n] uniforms in [0, 1), ``eids`` int32 [Q] or None. CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
    _check(g, nodes, times, u, eids)
    if g.device.type == "cpu":
        return sample_rows_plain(g, nodes, times, u, eids)
    if g.device.type != "cuda":
        raise ValueError(f"sample_rows: unsupported device {g.device}")
    q, n = u.shape
    out_node = torch.empty((q, n), dtype=torch.int32, device=g.device)
    out_eid = torch.empty((q, n), dtype=torch.int32, device=g.device)
    out_ts = torch.empty((q, n), dtype=torch.float32, device=g.device)
    err = _lib().sample_rows_launch(
        g.off.data_ptr(), g.ngh_node.data_ptr(), g.ngh_eid.data_ptr(),
        g.ngh_ts.data_ptr(), g.edge_ts.data_ptr(), nodes.data_ptr(),
        None if times is None else times.data_ptr(),
        None if eids is None else eids.data_ptr(),
        u.data_ptr(), q, n, g.num_nodes, g.num_edges,
        out_node.data_ptr(), out_eid.data_ptr(), out_ts.data_ptr(),
        torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(err, "sample_rows")
    sample_rows.launches += 1
    return out_node, out_eid, out_ts


sample_rows.launches = 0


def _typed(lib):
    """``lib`` with the launcher's argument and result types set."""
    fn = lib.sample_rows_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i] * 4 + [p] * 4
        fn.restype = ctypes.c_int
    return lib


def _lib():
    return _typed(_build.load("sample_rows"))
