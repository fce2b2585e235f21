"""Rebuild a trained base model (module, weights and TGN memory) from the
checkpoint its driver wrote.

Port of ``tempme_tpu/train/base_loader.py:26-77``: the JSON meta names
the architecture, the ``.pt`` blob that ``learn_base.main`` writes holds
the parameters (and the TGN's train-side memory). A TGAT of 3 or more
layers checkpoints its blocks (``remat``), as the JAX loader builds it. A
GraphMixer gets ``meta["n_layer"]`` mixer blocks and ``meta["n_degree"]``
tokens. Every load is strict: a checkpoint whose blocks differ from its
meta raises (flax's reader drops the parameters its template lacks).
The explainer reads a frozen base; the enhance stage trains the base it
loads (``trainable=True``). Neither form holds a dropout module: a model's
training form is the dropout draws its caller passes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.graphmixer import GraphMixer
from ..models.tgat import TGAT
from ..models.tgn import TGN, TGNMemoryState
from ..utils.checkpoint import load_checkpoint
from ..utils.devices import resolve_device


class LoadedBase(NamedTuple):
    base_type: str
    model: torch.nn.Module
    memory: Optional[TGNMemoryState]   # the TGN's memory, else None
    meta: dict


def load_base(ckpt_path: str, device=None,
              compute_dtype: torch.dtype = torch.bfloat16,
              trainable: bool = False) -> LoadedBase:
    """The base of ``ckpt_path`` on ``device`` (CUDA unless
    ``device="cpu"``): frozen (no parameter requires a gradient, eval
    form), or with ``trainable`` every parameter requiring one.
    ``compute_dtype`` is the attention projections' type of a TGN or a
    TGAT, bf16 as in the JAX package (a GraphMixer is float32)."""
    dev = resolve_device(device)
    blob, meta = load_checkpoint(ckpt_path, map_location="cpu")
    base_type = meta["base_type"]
    if base_type == "graphmixer":
        model = GraphMixer(node_dim=meta["node_dim"],
                           edge_dim=meta["edge_dim"],
                           num_tokens=meta["n_degree"],
                           num_layers=meta["n_layer"],
                           dropout=meta["drop_out"], device=dev)
        return _loaded(base_type, model, blob, meta, trainable)
    if base_type == "tgat":
        model = TGAT(node_dim=meta["node_dim"], edge_dim=meta["edge_dim"],
                     num_layers=meta["n_layer"], n_head=meta["n_head"],
                     dropout=meta["drop_out"],
                     agg_method=meta.get("agg_method", "attn"),
                     attn_mode=meta.get("attn_mode", "prod"),
                     use_time=meta.get("use_time", "time"),
                     remat=meta["n_layer"] >= 3, device=dev,
                     compute_dtype=compute_dtype)
        return _loaded(base_type, model, blob, meta, trainable)
    if base_type != "tgn":
        raise ValueError(f"unknown base_type {base_type}")
    model = TGN(node_dim=meta["node_dim"], edge_dim=meta["edge_dim"],
                num_nodes=meta["num_nodes"], n_layers=meta["n_layer"],
                n_head=meta["n_head"], dropout=meta["drop_out"],
                memory_updater=meta.get("memory_updater", "gru"),
                aggregator=meta.get("aggregator", "last"),
                message_function=meta.get("message_function", "mlp"),
                embedding_type=meta.get("embedding_module",
                                        "graph_attention"),
                device=dev, compute_dtype=compute_dtype)
    memory = TGNMemoryState(**{k: v.to(dev)
                               for k, v in blob["memory"].items()})
    return _loaded(base_type, model, blob, meta, trainable, memory)


def _loaded(base_type, model, blob, meta, trainable,
            memory=None) -> LoadedBase:
    model.load_state_dict(blob["params"], strict=True)
    model.requires_grad_(trainable)
    model.train(trainable)
    return LoadedBase(base_type, model, memory, meta)
