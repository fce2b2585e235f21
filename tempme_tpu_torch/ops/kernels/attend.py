"""Fused 1-query x n-key attention: CUDA kernel wrappers, their autograd
form and their plain versions.

Replaces the TPU kernels ``tempme_tpu/ops/pallas/kernels.py``
``_attend_kernel`` (eval form) and ``_attend_drop_kernel`` (training form),
entry ``fused_attend``, and their custom VJPs. The forward kernels are
``csrc/attend.cu``; the backward is ``csrc/attend_bwd.cu``, which
recomputes the probabilities from the inputs as the JAX VJP does. Each
source's note gives its design and its bound (bytes).

Per row (batch x query, head): scores ``scale * q . k`` over the n keys,
-1e10 where masked, softmax, in the training form inverted dropout by the
given uniforms (``u >= rate`` keeps, scaled by ``1 / (1 - rate)``), times
the explain weight; returns the weighted value sum and the probabilities.
Layouts are the model's: q ``[m, h, dk]``, k and v ``[m, n, h, dk]``, mask
and explain weight ``[m, n]`` (shared by the heads), u ``[m, h, n]`` ->
out ``[m, h, dk]``, attn ``[m, h, n]``. q, k and v are float32 or bf16 (one
type for the three; the model's projections run in bf16 by default) and the
arithmetic is float32, as the Pallas body's ``astype(jnp.float32)``; the
mask is bool and everything else float32.

``attend`` and ``attend_drop`` take the plain version for CPU tensors. For
CUDA tensors they run the kernel inside one ``torch.autograd.Function``
whose backward is the ``attend_bwd`` kernel, which also gives the explain
weight its gradient (the TempME explainer trains through it). Each of the
three wrappers counts its kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build


def attend_plain(q, k, v, mask=None, ew=None, scale=1.0):
    """The plain PyTorch version (the JAX package's ``_attend_jnp``)."""
    return attend_drop_plain(q, k, v, mask, ew, None, 0.0, scale)


def attend_drop_plain(q, k, v, mask, ew, u, rate, scale=1.0):
    """The plain PyTorch version of the training form (the JAX package's
    ``_attend_drop_jnp``); ``u=None`` is the eval form. Computed in float32,
    or in float64 where q, k and v are float64 (a reference free of
    float32 round-off)."""
    dt = torch.promote_types(q.dtype, torch.float32)
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    scores = torch.einsum("mhd,mnhd->mhn", q, k) * scale
    if mask is not None:
        scores = scores.masked_fill(mask[:, None, :], -1e10)
    attn = torch.softmax(scores, dim=-1)
    if u is not None:
        attn = torch.where(u >= rate, attn / (1.0 - rate), 0.0)
    if ew is not None:
        attn = attn * ew[:, None, :]
    return torch.einsum("mhn,mnhd->mhd", attn, v), attn


def attend_bwd_plain(q, k, v, mask, ew, u, rate, scale, dout, dattn=None,
                     ew_grad=False):
    """(dq, dk, dv, dew or None) by autograd of the plain version."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        if ew_grad:
            leaves.append(ew.detach().requires_grad_())
        out, attn = attend_drop_plain(*leaves[:3], mask,
                                      leaves[3] if ew_grad else ew, u, rate,
                                      scale)
        outs, cts = [out], [dout]
        if dattn is not None:
            outs.append(attn)
            cts.append(dattn)
        grads = torch.autograd.grad(outs, leaves, cts)
        return tuple(grads) + (() if ew_grad else (None,))


def _check(q, k, v, mask, ew, u=None):
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError("q must be [m, h, dk] and k, v [m, n, h, dk]")
    m, h, dk = q.shape
    n = k.shape[1]
    if k.shape != (m, n, h, dk) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} "
                         f"do not fit q {tuple(q.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must be all float32 or all bfloat16")
    for t in (ew, u):
        if t is not None and t.dtype != torch.float32:
            raise ValueError("ew and u must be float32")
    if mask is not None and (mask.shape != (m, n) or mask.dtype != torch.bool):
        raise ValueError("mask must be a bool [m, n] tensor")
    if ew is not None and ew.shape != (m, n):
        raise ValueError("ew must be a float32 [m, n] tensor")
    if u is not None and u.shape != (m, h, n):
        raise ValueError("u must be a float32 [m, h, n] tensor")
    for t in (q, k, v, mask, ew, u):
        if t is not None and t.device != q.device:
            raise ValueError("all tensors must be on one device")
        if t is not None and q.device.type == "cuda" and not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")
    if q.device.type == "cuda" and n == 0:
        raise ValueError("the kernel takes at least one key")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"attend: unsupported device {q.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _bf16(q):
    """The element-type flag of q, k and v for the launchers."""
    return int(q.dtype == torch.bfloat16)


def _forward(q, k, v, mask, ew, u, rate, scale):
    """Launch the eval-form kernel (``u is None``) or the training-form
    kernel on the current stream."""
    m, h, dk = q.shape
    n = k.shape[1]
    out = torch.empty((m, h, dk), dtype=torch.float32, device=q.device)
    attn = torch.empty((m, h, n), dtype=torch.float32, device=q.device)
    lib = _lib("attend")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if u is None:
        err = lib.attend_launch(_ptr(q), _ptr(k), _ptr(v), _ptr(mask),
                                _ptr(ew), m, h, n, dk, _bf16(q), float(scale),
                                out.data_ptr(), attn.data_ptr(), stream)
        _build.check(err, "attend")
        attend.launches += 1
    else:
        err = lib.attend_drop_launch(_ptr(q), _ptr(k), _ptr(v), _ptr(mask),
                                     _ptr(ew), u.data_ptr(), m, h, n, dk,
                                     _bf16(q), float(scale), float(rate),
                                     out.data_ptr(), attn.data_ptr(), stream)
        _build.check(err, "attend_drop")
        attend_drop.launches += 1
    return out, attn


class _Attend(torch.autograd.Function):
    """The kernel forward; the backward is the ``attend_bwd`` kernel on the
    saved inputs (nothing else is kept)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, ew, u, rate, scale):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, mask, ew, u)
        ctx.rate, ctx.scale = rate, scale
        return _forward(q, k, v, mask, ew, u, rate, scale)

    @staticmethod
    def backward(ctx, dout, dattn):
        q, k, v, mask, ew, u = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dq, dk, dv, dew = attend_bwd(
            q, k, v, mask, ew, u, ctx.rate, ctx.scale, dout.contiguous(),
            None if dattn is None else dattn.contiguous(),
            ew_grad=ctx.needs_input_grad[4])
        return dq, dk, dv, None, dew, None, None, None


def attend(q, k, v, mask=None, ew=None, scale=1.0):
    """Eval form: (out [m, h, dk], attn [m, h, n]). ``mask`` bool [m, n]
    (True = masked) or None; ``ew`` float32 [m, n] or None (weight 1). CPU
    tensors take the plain version; CUDA tensors launch the kernel (its
    gradient is the ``attend_bwd`` kernel)."""
    _check(q, k, v, mask, ew)
    if q.device.type == "cpu":
        return attend_plain(q, k, v, mask, ew, scale)
    return _Attend.apply(q, k, v, mask, ew, None, 0.0, float(scale))


def attend_drop(q, k, v, mask, ew, u, rate, scale=1.0):
    """Training form: ``attend`` with inverted dropout on the probabilities
    by the uniforms ``u`` float32 [m, h, n], between the softmax and the
    explain weight."""
    if u is None:
        raise ValueError("attend_drop needs the dropout draws u")
    _check(q, k, v, mask, ew, u)
    if q.device.type == "cpu":
        return attend_drop_plain(q, k, v, mask, ew, u, rate, scale)
    return _Attend.apply(q, k, v, mask, ew, u, float(rate), float(scale))


def attend_bwd(q, k, v, mask, ew, u, rate, scale, dout, dattn=None,
               ew_grad=False):
    """(dq [m, h, dk], dk, dv [m, n, h, dk], dew [m, n] or None) of either
    form for the cotangents ``dout`` [m, h, dk] and ``dattn`` [m, h, n] (or
    None); dq, dk and dv in the type of q, dew (only with ``ew_grad``, which
    needs ``ew``) float32. CPU tensors take autograd of the plain version;
    CUDA tensors launch the kernel, one launch in all: it sums the explain
    weight's gradient over the heads itself and writes dew ``[m, n]``."""
    if ew_grad and ew is None:
        raise ValueError("ew_grad needs the explain weight ew")
    _check(q, k, v, mask, ew, u)
    for t, shape in ((dout, q.shape), (dattn, q.shape[:2] + k.shape[1:2])):
        if t is not None and (t.shape != shape or t.dtype != torch.float32
                              or t.device != q.device):
            raise ValueError("dout must be [m, h, dk] and dattn [m, h, n], "
                             "float32, on q's device")
        if t is not None and q.device.type == "cuda" and \
                not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")
    if q.device.type == "cpu":
        return attend_bwd_plain(q, k, v, mask, ew, u, rate, scale, dout,
                                dattn, ew_grad)
    m, h, dk = q.shape
    n = k.shape[1]
    dq = torch.empty_like(q)
    dkey = torch.empty_like(k)
    dval = torch.empty_like(v)
    dew = torch.empty((m, n), dtype=torch.float32, device=q.device) \
        if ew_grad else None
    err = _lib("attend_bwd").attend_bwd_launch(
        _ptr(q), _ptr(k), _ptr(v), _ptr(mask), _ptr(ew), _ptr(u), m, h, n,
        dk, _bf16(q), float(scale), float(rate), _ptr(dout), _ptr(dattn),
        dq.data_ptr(), dkey.data_ptr(), dval.data_ptr(), _ptr(dew),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "attend_bwd")
    attend_bwd.launches += 1
    return dq, dkey, dval, dew


attend.launches = 0
attend_drop.launches = 0
attend_bwd.launches = 0

_ARGTYPES = {
    # q, k, v, mask, ew | m, h, n, dk, bf16 | scale | out, attn, stream
    "attend_launch": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
    + [ctypes.c_float] + [ctypes.c_void_p] * 3,
    # q, k, v, mask, ew, u | m, h, n, dk, bf16 | scale, rate |
    # out, attn, stream
    "attend_drop_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
    + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 3,
    # q, k, v, mask, ew, u | m, h, n, dk, bf16 | scale, rate |
    # dout, dattn, dq, dk, dv, dew (null or [m, n], summed over the heads in
    # the kernel), stream
    "attend_bwd_launch": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
    + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 7,
}


def _typed(lib):
    """``lib`` with the launchers' argument and result types set."""
    for fn_name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, fn_name, None)
        if fn is not None and fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _lib(name):
    return _typed(_build.load(name))
