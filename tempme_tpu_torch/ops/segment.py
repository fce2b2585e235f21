"""Segment reductions of the explainer.

Port of ``tempme_tpu/ops/segment.py``: the walk -> edge scatter-max fused
with the gather back onto the support's edge ids (the ``walk_to_edge``
kernel, so the working set is [B, T, S] compares in registers, never a
dense [B, num_edges] table), the per-class mean of walk probabilities and
the per-walk edge co-occurrence counts.
"""
from __future__ import annotations

import torch

from .kernels.walk_to_edge import walk_to_edge


def walk_to_edge_max(walk_edge_ids, walk_imp, target_edge_ids):
    """For each target edge id, the max importance over the walk slots that
    carry it, 0 where none does: walk_edge_ids int32 [B, S], walk_imp
    float32 [B, S], target_edge_ids int32 [B, T] -> [B, T]. The kernel on
    CUDA tensors, its plain version on CPU tensors."""
    return walk_to_edge(walk_edge_ids.to(torch.int32).contiguous(),
                        walk_imp.contiguous(),
                        target_edge_ids.to(torch.int32).contiguous())


def class_mean(prob, cat, num_classes: int = 12):
    """Per-class mean of walk probabilities: prob [B, W], cat [B, W] ->
    [B, num_classes], 0 for empty classes."""
    oh = torch.nn.functional.one_hot(cat.long(), num_classes).to(prob.dtype)
    s = torch.einsum("bw,bwc->bc", prob, oh)
    cnt = oh.sum(dim=1)
    return torch.where(cnt > 0, s / cnt.clamp(min=1.0), 0.0)


def edge_cooccurrence_counts(walk_edge_ids):
    """Per-walk edge co-occurrence counts: out[b, m, c, c2] = #{walks m' :
    edge[b, m', c2] == edge[b, m, c]}, [B, W, 3] -> [B, W, 3, 3] float32
    (padding id 0 counts like any other id)."""
    e = walk_edge_ids
    eq = e[:, :, :, None, None] == e[:, None, None, :, :]   # [B, W, 3, W, 3]
    return eq.sum(dim=3).to(torch.float32)
