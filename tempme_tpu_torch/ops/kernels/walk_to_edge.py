"""Walk -> edge scatter-max: CUDA kernel wrappers, their autograd form and
the plain version.

Replaces the TPU kernel ``tempme_tpu/ops/pallas/kernels.py``
(``_w2e_kernel``, entry ``walk_to_edge_max``) and its VJP (``_w2e_bwd``,
which differentiates ``tempme_tpu/ops/segment.py::walk_to_edge_max_jnp``);
both directions are kernels in ``csrc/walk_to_edge.cu``, whose note gives
the design and the bound.

``out[b, t] = max_s (ids[b, s] == tgt[b, t] ? imp[b, s] : 0)``: for each
target edge id, the largest importance of the walk slots that carry it, 0
where none does (the fill takes part in the max). The gradient splits each
cotangent evenly over every slot that attains the max, as JAX's max does,
non-matching slots whose 0 ties with it included (their share reaches no
importance).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build


def walk_to_edge_plain(ids, imp, tgt):
    """The plain PyTorch version (the JAX package's
    ``walk_to_edge_max_jnp``). ``amax`` splits the gradient among ties as
    JAX's max does; ``max(dim)`` would send it all to one slot."""
    eq = tgt[:, :, None] == ids[:, None, :]
    return torch.where(eq, imp[:, None, :], 0.0).amax(dim=-1)


def walk_to_edge_count_plain(ids, imp, tgt):
    """The plain form of the forward kernel's ``cnt``: for each target, the
    number of slots whose value (the importance where the id matches, else
    the 0 fill) equals the max. int32 [B, T]."""
    eq = tgt[:, :, None] == ids[:, None, :]
    scores = torch.where(eq, imp[:, None, :], 0.0)
    return (scores == scores.amax(dim=-1, keepdim=True)).sum(
        dim=-1, dtype=torch.int32)


def _check(ids, imp, tgt):
    if ids.dim() != 2 or ids.dtype != torch.int32 or imp.shape != ids.shape \
            or imp.dtype != torch.float32:
        raise ValueError("ids must be int32 [B, S] and imp float32 [B, S]")
    if tgt.dim() != 2 or tgt.shape[0] != ids.shape[0] or \
            tgt.dtype != torch.int32:
        raise ValueError("tgt must be an int32 [B, T] tensor")
    for t in (imp, tgt):
        if t.device != ids.device:
            raise ValueError("all tensors must be on one device")
    if ids.device.type == "cuda" and not all(
            t.is_contiguous() for t in (ids, imp, tgt)):
        raise ValueError("the kernel takes contiguous tensors")
    if ids.device.type not in ("cpu", "cuda"):
        raise ValueError(f"walk_to_edge: unsupported device {ids.device}")


def walk_to_edge_fwd(ids, imp, tgt):
    """Launch the forward kernel: (out [B, T] float32, cnt [B, T] int32,
    the number of slots that attain each max)."""
    b, s = ids.shape
    t = tgt.shape[1]
    out = torch.empty((b, t), dtype=torch.float32, device=ids.device)
    cnt = torch.empty((b, t), dtype=torch.int32, device=ids.device)
    err = _lib().w2e_fwd_launch(
        ids.data_ptr(), imp.data_ptr(), tgt.data_ptr(), b, s, t,
        out.data_ptr(), cnt.data_ptr(),
        torch.cuda.current_stream(ids.device).cuda_stream)
    _build.check(err, "walk_to_edge")
    walk_to_edge_fwd.launches += 1
    return out, cnt


def walk_to_edge_bwd(ids, imp, tgt, out, cnt, ct):
    """Launch the backward kernel: the importance's gradient [B, S] for the
    cotangent ``ct`` [B, T] of the forward's ``out`` (``cnt`` from the same
    forward)."""
    b, s = ids.shape
    t = tgt.shape[1]
    g_imp = torch.empty((b, s), dtype=torch.float32, device=ids.device)
    err = _lib().w2e_bwd_launch(
        ids.data_ptr(), imp.data_ptr(), tgt.data_ptr(), out.data_ptr(),
        cnt.data_ptr(), ct.data_ptr(), b, s, t, g_imp.data_ptr(),
        torch.cuda.current_stream(ids.device).cuda_stream)
    _build.check(err, "walk_to_edge_bwd")
    walk_to_edge_bwd.launches += 1
    return g_imp


walk_to_edge_fwd.launches = 0
walk_to_edge_bwd.launches = 0


class _WalkToEdge(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ids, imp, tgt):
        out, cnt = walk_to_edge_fwd(ids, imp, tgt)
        ctx.save_for_backward(ids, imp, tgt, out, cnt)
        return out

    @staticmethod
    def backward(ctx, ct):
        ids, imp, tgt, out, cnt = ctx.saved_tensors
        return None, walk_to_edge_bwd(ids, imp, tgt, out, cnt,
                                      ct.contiguous()), None


def walk_to_edge(ids, imp, tgt):
    """``ids`` int32 [B, S] walk slots' edge ids, ``imp`` float32 [B, S]
    their importance, ``tgt`` int32 [B, T] target edge ids -> [B, T]
    float32. CPU tensors take the plain version; CUDA tensors launch the
    forward kernel, and the backward kernel when a gradient is asked for."""
    _check(ids, imp, tgt)
    if ids.device.type == "cpu":
        return walk_to_edge_plain(ids, imp, tgt)
    return _WalkToEdge.apply(ids, imp, tgt)


def _typed(lib):
    """``lib`` with the launchers' argument and result types set."""
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, argtypes in (("w2e_fwd_launch", [p] * 3 + [i] * 3 + [p] * 3),
                           ("w2e_bwd_launch", [p] * 6 + [i] * 3 + [p] * 2)):
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _lib():
    return _typed(_build.load("walk_to_edge"))
