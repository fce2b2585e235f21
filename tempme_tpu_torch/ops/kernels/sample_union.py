"""Walk event 2: CUDA kernel wrapper and plain version.

Replaces the TPU kernel ``tempme_tpu/ops/pallas/sample_kernel.py``
(``_sample_union_kernel``, entry ``sample_union``); the kernel is
``csrc/sample_union.cu``, whose note gives its design and its bound. It runs
a warp per query: lanes 0-15 and 16-31 search the two histories' cuts at the
same time as 17-ary lower bounds, and lane j makes pick j, the lanes storing
to consecutive addresses. Its bound is bytes (the ids, offsets, a bisect's
probes a side, the draws, the picked entries and the outputs); its time is
one query's chain of dependent loads.

For each query (node_a, node_b, eid_cut) it draws ``n`` events uniformly,
with replacement, from the union of the two nodes' histories strictly
before edge ``eid_cut``'s time (a side is empty where its node or
``eid_cut`` is 0): ``r = clip(floor(u * (cut_a + cut_b)), 0, total - 1)``
is a's entry ``r`` or b's entry ``r - cut_a``. It returns (src, ngh, eid,
ts), src being the node whose history the event came from; all zeros where
the union is empty. Outputs are bit-identical to the JAX package's CSR
branch (``tempme_tpu/ops/sampler.py::_union_uniform_sample``) given the
same uniforms.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .sample_rows import cut_by_edge


def sample_union_plain(g, node_a, node_b, eid_cut, u):
    """The plain PyTorch version: ([Q, n] int32 src, ngh, eid, [Q, n]
    float32 ts)."""
    start_a, cut_a = cut_by_edge(g, node_a, eid_cut)
    start_b, cut_b = cut_by_edge(g, node_b, eid_cut)
    total = (cut_a + cut_b)[:, None]
    r = torch.floor(u * total.to(torch.float32)).to(torch.int64)
    r = torch.minimum(r.clamp(min=0), (total - 1).clamp(min=0))
    from_a = r < cut_a[:, None]
    pos = torch.where(from_a, start_a[:, None] + r,
                      start_b[:, None] + (r - cut_a[:, None]))
    pos = pos.clamp(0, max(g.ngh_ts.shape[0] - 1, 0))
    valid = total > 0
    zero = torch.zeros((), dtype=torch.int32, device=u.device)
    src = torch.where(from_a, node_a[:, None], node_b[:, None])
    return (torch.where(valid, src, zero),
            torch.where(valid, g.ngh_node[pos], zero),
            torch.where(valid, g.ngh_eid[pos], zero),
            torch.where(valid, g.ngh_ts[pos], zero.to(torch.float32)))


def _check(g, node_a, node_b, eid_cut, u):
    if u.dim() != 2 or u.dtype != torch.float32:
        raise ValueError("u must be a float32 [Q, n] tensor")
    for t in (node_a, node_b, eid_cut):
        if t.shape != (u.shape[0],) or t.dtype != torch.int32:
            raise ValueError("node_a, node_b and eid_cut must be int32 [Q]")
    for t in (node_a, node_b, eid_cut, u):
        if t.device != g.device:
            raise ValueError(f"tensor on {t.device}, graph on {g.device}")
        if g.device.type == "cuda" and not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")
    if g.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sample_union: unsupported device {g.device}")


def sample_union(g, node_a, node_b, eid_cut, u):
    """``n = u.shape[1]`` uniform picks per query from the union of
    ``node_a``'s and ``node_b``'s histories cut before edge ``eid_cut``.
    ``node_a``, ``node_b``, ``eid_cut`` int32 [Q], ``u`` float32 [Q, n] in
    [0, 1). CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    _check(g, node_a, node_b, eid_cut, u)
    if g.device.type == "cpu":
        return sample_union_plain(g, node_a, node_b, eid_cut, u)
    q, n = u.shape
    outs = [torch.empty((q, n), dtype=dt, device=g.device)
            for dt in (torch.int32, torch.int32, torch.int32, torch.float32)]
    err = _lib().sample_union_launch(
        g.off.data_ptr(), g.ngh_node.data_ptr(), g.ngh_eid.data_ptr(),
        g.ngh_ts.data_ptr(), g.edge_ts.data_ptr(), node_a.data_ptr(),
        node_b.data_ptr(), eid_cut.data_ptr(), u.data_ptr(), q, n,
        g.num_nodes, g.num_edges, *(o.data_ptr() for o in outs),
        torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(err, "sample_union")
    sample_union.launches += 1
    return tuple(outs)


sample_union.launches = 0


def _typed(lib):
    """``lib`` with the launcher's argument and result types set."""
    fn = lib.sample_union_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i] * 4 + [p] * 5
        fn.restype = ctypes.c_int
    return lib


def _lib():
    return _typed(_build.load("sample_union"))
