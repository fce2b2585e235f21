"""Fused 1-query x n-key attention (eval form): CUDA kernel wrapper and
plain version.

Replaces the TPU kernel ``tempme_tpu/ops/pallas/kernels.py``
(``_attend_kernel``, entry ``fused_attend``); the kernel is
``csrc/attend.cu``, whose note gives its design and its bound (bytes).

Per row (batch x query, head): scores ``scale * q . k`` over the n keys,
-1e10 where masked, softmax, times the explain weight; returns the weighted
value sum and the probabilities. Layouts are the model's: q ``[m, h, dk]``,
k and v ``[m, n, h, dk]``, mask and explain weight ``[m, n]`` (shared by the
heads) -> out ``[m, h, dk]``, attn ``[m, h, n]``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build


def attend_plain(q, k, v, mask=None, ew=None, scale=1.0):
    """The plain PyTorch version (the JAX package's ``_attend_jnp``)."""
    scores = torch.einsum("mhd,mnhd->mhn", q, k) * scale
    if mask is not None:
        scores = scores.masked_fill(mask[:, None, :], -1e10)
    attn = torch.softmax(scores, dim=-1)
    if ew is not None:
        attn = attn * ew[:, None, :]
    return torch.einsum("mhn,mnhd->mhd", attn, v), attn


def _check(q, k, v, mask, ew):
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError("q must be [m, h, dk] and k, v [m, n, h, dk]")
    m, h, dk = q.shape
    n = k.shape[1]
    if k.shape != (m, n, h, dk) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} "
                         f"do not fit q {tuple(q.shape)}")
    for t in (q, k, v, ew):
        if t is not None and t.dtype != torch.float32:
            raise ValueError("q, k, v and ew must be float32")
    if mask is not None and (mask.shape != (m, n) or mask.dtype != torch.bool):
        raise ValueError("mask must be a bool [m, n] tensor")
    if ew is not None and ew.shape != (m, n):
        raise ValueError("ew must be a float32 [m, n] tensor")
    for t in (q, k, v, mask, ew):
        if t is not None and t.device != q.device:
            raise ValueError("all tensors must be on one device")
        if t is not None and q.device.type == "cuda" and not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")


def attend(q, k, v, mask=None, ew=None, scale=1.0):
    """(out [m, h, dk], attn [m, h, n]). ``mask`` bool [m, n] (True =
    masked) or None; ``ew`` float32 [m, n] or None (weight 1). CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    _check(q, k, v, mask, ew)
    if q.device.type == "cpu":
        return attend_plain(q, k, v, mask, ew, scale)
    if q.device.type != "cuda":
        raise ValueError(f"attend: unsupported device {q.device}")
    m, h, dk = q.shape
    n = k.shape[1]
    out = torch.empty((m, h, dk), dtype=torch.float32, device=q.device)
    attn = torch.empty((m, h, n), dtype=torch.float32, device=q.device)
    err = _lib().attend_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(),
        None if ew is None else ew.data_ptr(), m, h, n, dk, float(scale),
        out.data_ptr(), attn.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "attend")
    attend.launches += 1
    return out, attn


attend.launches = 0


def _lib():
    lib = _build.load("attend")
    fn = lib.attend_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 5 + [i] * 4 + [ctypes.c_float] + [p] * 3
        fn.restype = ctypes.c_int
    return lib
