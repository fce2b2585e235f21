"""Walk event 3: CUDA kernel wrapper and plain version.

Replaces the TPU kernel ``tempme_tpu/ops/pallas/sample_kernel.py``
(``_sample_masked_kernel``, entry ``sample_masked_union``) by the scheme of
the JAX package's CSR branch (``tempme_tpu/ops/sampler.py::
_masked_union_sample``, from ``:454``); the kernel is
``csrc/sample_masked.cu``, whose note gives its design and its bound.

For each query it picks one event uniformly from the union of node_a's and
node_b's histories strictly before edge ``eid_cut``'s time, restricted to
candidates: on a's side the neighbours ``va1`` and ``va2``, on b's side
``vb1``, and no restriction where ``wildcard`` is set. The candidates of one
(node, neighbour) pair are a contiguous range of the graph's secondary CSR
(``bynb_*``, sorted by node, neighbour and time), found by a double bisect,
so counting them is O(log degree). Returns (src, ngh, eid, ts, found); zeros
and ``found = False`` where there is no candidate. Outputs are
bit-identical to the JAX CSR branch given the same uniforms.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .sample_rows import cut_by_edge


def _nb_lower(g, nodes, x, t):
    """First index in each node's slice of the secondary CSR whose
    (neighbour, time) is not below (x, t): the JAX package's fixed-iteration
    vectorised bisect. int64 [Q]."""
    v = nodes.long().clamp(0, g.num_nodes - 1)
    lo, hi = g.off[v].long(), g.off[v + 1].long()
    last = max(g.ngh_ts.shape[0] - 1, 0)
    iters = max(1, int(math.ceil(math.log2(max(2, g.max_degree + 1)))) + 1)
    for _ in range(iters):
        active = lo < hi
        mid = (lo + hi) // 2
        at = mid.clamp(max=last)
        nm, tm = g.bynb_ngh[at], g.bynb_ts[at]
        below = (nm < x) | ((nm == x) & (tm < t))
        lo = torch.where(active & below, mid + 1, lo)
        hi = torch.where(active & ~below, mid, hi)
    return lo


def sample_masked_plain(g, node_a, node_b, eid_cut, va1, va2, vb1, wildcard,
                        u):
    """The plain PyTorch version: ([Q] int32 src, ngh, eid, [Q] float32 ts,
    [Q] bool found). Gathers clamp their positions, as the JAX package's
    do, and the rows without a candidate are masked after."""
    start_a, cut_a = cut_by_edge(g, node_a, eid_cut)
    start_b, cut_b = cut_by_edge(g, node_b, eid_cut)
    t_cut = g.edge_ts[eid_cut.long().clamp(0, g.num_edges - 1)]
    neg = torch.full_like(t_cut, -math.inf)

    def cand_range(nodes, x, empty):
        lo = _nb_lower(g, nodes, x, neg)
        hi = _nb_lower(g, nodes, x, t_cut)
        return lo, torch.where(empty, 0, hi - lo)

    empty_a = (node_a == 0) | (eid_cut == 0)
    empty_b = (node_b == 0) | (eid_cut == 0)
    lo_a1, cnt_a1 = cand_range(node_a, va1, empty_a)
    lo_a2, cnt_a2 = cand_range(node_a, va2, empty_a)
    lo_b1, cnt_b1 = cand_range(node_b, vb1, empty_b)
    m_a = torch.where(wildcard, cut_a, cnt_a1 + cnt_a2)
    m_b = torch.where(wildcard, cut_b, cnt_b1)
    total = m_a + m_b
    found = total > 0
    r = torch.floor(u * total.to(torch.float32)).to(torch.int64)
    r = torch.minimum(r.clamp(min=0), (total - 1).clamp(min=0))
    from_a = r < m_a
    local = torch.where(from_a, r, r - m_a)
    last = max(g.ngh_ts.shape[0] - 1, 0)
    pos_t = (torch.where(from_a, start_a, start_b) + local).clamp(0, last)
    in_a1 = from_a & (local < cnt_a1)
    pos_n = torch.where(in_a1, lo_a1 + local,
                        torch.where(from_a, lo_a2 + (local - cnt_a1),
                                    lo_b1 + local)).clamp(0, last)
    ngh = torch.where(wildcard, g.ngh_node[pos_t], g.bynb_ngh[pos_n])
    eid = torch.where(wildcard, g.ngh_eid[pos_t], g.bynb_eid[pos_n])
    ts = torch.where(wildcard, g.ngh_ts[pos_t], g.bynb_ts[pos_n])
    src = torch.where(from_a, node_a, node_b)
    zero = torch.zeros((), dtype=torch.int32, device=u.device)
    return (torch.where(found, src, zero), torch.where(found, ngh, zero),
            torch.where(found, eid, zero),
            torch.where(found, ts, zero.to(torch.float32)), found)


def _check(g, ints, wildcard, u):
    q = u.shape[0]
    if u.shape != (q,) or u.dtype != torch.float32:
        raise ValueError("u must be a float32 [Q] tensor")
    for t in ints:
        if t.shape != (q,) or t.dtype != torch.int32:
            raise ValueError("node_a, node_b, eid_cut, va1, va2 and vb1 "
                             "must be int32 [Q]")
    if wildcard.shape != (q,) or wildcard.dtype != torch.bool:
        raise ValueError("wildcard must be a bool [Q] tensor")
    for t in (*ints, wildcard, u):
        if t.device != g.device:
            raise ValueError(f"tensor on {t.device}, graph on {g.device}")
        if g.device.type == "cuda" and not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")
    if g.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sample_masked: unsupported device {g.device}")


def sample_masked(g, node_a, node_b, eid_cut, va1, va2, vb1, wildcard, u):
    """One candidate-restricted pick per query. ``node_a``, ``node_b``,
    ``eid_cut``, ``va1``, ``va2``, ``vb1`` int32 [Q], ``wildcard`` bool [Q],
    ``u`` float32 [Q] in [0, 1). CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    ints = (node_a, node_b, eid_cut, va1, va2, vb1)
    _check(g, ints, wildcard, u)
    if g.device.type == "cpu":
        return sample_masked_plain(g, *ints, wildcard, u)
    q = u.shape[0]
    outs = [torch.empty((q,), dtype=dt, device=g.device)
            for dt in (torch.int32, torch.int32, torch.int32, torch.float32,
                       torch.bool)]
    err = _lib().sample_masked_launch(
        g.off.data_ptr(), g.ngh_node.data_ptr(), g.ngh_eid.data_ptr(),
        g.ngh_ts.data_ptr(), g.bynb_ngh.data_ptr(), g.bynb_eid.data_ptr(),
        g.bynb_ts.data_ptr(), g.edge_ts.data_ptr(),
        *(t.data_ptr() for t in ints), wildcard.data_ptr(), u.data_ptr(), q,
        g.num_nodes, g.num_edges, *(o.data_ptr() for o in outs),
        torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(err, "sample_masked")
    sample_masked.launches += 1
    return tuple(outs)


sample_masked.launches = 0


def _typed(lib):
    """``lib`` with the launcher's argument and result types set."""
    fn = lib.sample_masked_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 16 + [i] * 3 + [p] * 6
        fn.restype = ctypes.c_int
    return lib


def _lib():
    return _typed(_build.load("sample_masked"))
