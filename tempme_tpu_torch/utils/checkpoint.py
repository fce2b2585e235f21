"""Checkpoints in the port's own format: ``torch.save`` blobs with the JSON
meta sidecar of ``tempme_tpu/utils/checkpoint.py``.

A blob is a dict of tensors and plain containers (a model's
``state_dict``, an optimizer's ``state_dict``, a generator's state, the
memory's fields); it is written to a temporary file and renamed, so a crash
never leaves half a checkpoint. ``path + ".json"`` holds the meta.
"""
from __future__ import annotations

import json
import os
import os.path as osp
from typing import Optional, Tuple

import torch


def save_checkpoint(path: str, blob: dict,
                    meta: Optional[dict] = None) -> None:
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)
    if meta is not None:
        with open(path + ".json", "w") as f:
            json.dump(meta, f, indent=1)


def load_meta(path: str) -> dict:
    with open(path + ".json") as f:
        return json.load(f)


def load_checkpoint(path: str, map_location=None) -> Tuple[dict, dict]:
    """(blob, meta); tensors land on ``map_location`` (their saved device
    by default)."""
    blob = torch.load(path, map_location=map_location, weights_only=True)
    return blob, load_meta(path)
