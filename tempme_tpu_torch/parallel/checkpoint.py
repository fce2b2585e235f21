"""Checkpoints of the replicated dp train state, restorable at any world
size.

Port of ``tempme_tpu/parallel/checkpoint.py`` (Orbax there). Under
replicated-state dp every rank holds the same bytes, so rank 0 alone writes
the state (parameters, Adam state, memory, generator and the step) in the
port's checkpoint format (``utils/checkpoint.py``) under
``{ckpt_dir}/step_{step}``, and every rank, at any world size, reads the
same file onto its own device: the dp analog of JAX's resharding restore.
"""
from __future__ import annotations

import os
import os.path as osp
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..utils.checkpoint import load_checkpoint, save_checkpoint
from .multihost import sync

STATE_FILE = "state.pt"


def _rank() -> int:
    live = dist.is_available() and dist.is_initialized()
    return dist.get_rank() if live else 0


def to_cpu(tree):
    """``tree`` (dicts, lists and tuples of tensors) with every tensor
    detached on the CPU (a CPU tensor is not copied)."""
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    return tree


def save_sharded(ckpt_dir: str, state: dict, step: int) -> str:
    """Rank 0 writes ``state`` (a dict of tensors and plain containers)
    and ``step`` under ``ckpt_dir/step_{step}``; then every rank meets at a
    barrier. Returns the step's directory."""
    path = osp.abspath(osp.join(ckpt_dir, f"step_{step}"))
    if _rank() == 0:
        save_checkpoint(osp.join(path, STATE_FILE),
                        dict(to_cpu(state), step=step),
                        meta=dict(step=step))
    sync(f"save_sharded step {step}")
    return path


def _like(x, ref, where: str):
    if torch.is_tensor(x):
        if torch.is_tensor(ref):
            if x.shape != ref.shape:
                raise ValueError(f"checkpoint {where}: shape "
                                 f"{tuple(x.shape)}, template "
                                 f"{tuple(ref.shape)}")
            return x.to(ref.device)
        return x
    if isinstance(x, dict):
        ref = ref if isinstance(ref, dict) else {}
        return {k: _like(v, ref.get(k), f"{where}.{k}")
                for k, v in x.items()}
    return x


def restore_sharded(ckpt_dir: str, step: int, template: dict) -> dict:
    """``step``'s state at any world size: the keys of ``template`` (the
    saved ``state``'s structure, such as this rank's current state) must
    all be there; a tensor whose path ``template`` also holds takes its
    device and must have its shape, any other (the Adam state of a fresh
    optimizer, the generator's) stays on the CPU for its owner's
    ``load_state_dict``. The ``step`` entry comes back too."""
    blob, _ = load_checkpoint(osp.join(ckpt_dir, f"step_{step}", STATE_FILE),
                              map_location="cpu")
    missing = set(template) - set(blob)
    if missing:
        raise ValueError(f"checkpoint step {step} lacks {sorted(missing)}")
    return _like(blob, template, "state")


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The highest saved step in ``ckpt_dir`` (None if empty or missing)."""
    if not osp.isdir(ckpt_dir):
        return None
    steps = [int(d[len("step_"):]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and d[len("step_"):].isdigit()]
    return max(steps) if steps else None
