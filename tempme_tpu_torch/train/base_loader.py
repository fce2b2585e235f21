"""Rebuild a trained base model (module, weights and TGN memory) from the
checkpoint its driver wrote.

Port of ``tempme_tpu/train/base_loader.py:26-77``: the JSON meta names
the architecture, the ``.pt`` blob that ``learn_base.main`` writes holds
the parameters (and the TGN's train-side memory). A TGAT of 3 or more
layers checkpoints its attn/prod blocks (``remat``), as the JAX loader
builds it; its variant flags and ``pos_seq_len``, and a TGN's variant
flags and time statistics, come from the meta, with the JAX loader's
defaults where an older meta lacks them. A GraphMixer gets ``meta["n_layer"]`` mixer blocks and ``meta["n_degree"]``
tokens. Every load is strict: a checkpoint whose blocks differ from its
meta raises (flax's reader drops the parameters its template lacks).
A checkpoint the JAX package wrote (flax msgpack, ``*.msgpack``, with the
same meta sidecar) loads too: its tree is read without flax and converted
(``utils/convert.py``), its TGN memory taken field by field.
The explainer reads a frozen base; the enhance stage trains the base it
loads (``trainable=True``). Neither form holds a dropout module: a model's
training form is the dropout draws its caller passes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.graphmixer import GraphMixer
from ..models.tgat import TGAT
from ..models.tgn import TGN, TGNMemoryState
from ..utils.checkpoint import load_checkpoint, load_meta
from ..utils.convert import flax_to_state_dict, read_flax_msgpack
from ..utils.devices import resolve_device


class LoadedBase(NamedTuple):
    base_type: str
    model: torch.nn.Module
    memory: Optional[TGNMemoryState]   # the TGN's memory, else None
    meta: dict


def read_base_checkpoint(ckpt_path: str):
    """(blob, meta) of a base checkpoint: the port's ``torch.save`` blob,
    or a JAX package's flax msgpack (``*.msgpack``) as the same blob, its
    parameters converted and a TGN's memory fields as CPU tensors."""
    if not ckpt_path.endswith(".msgpack"):
        return load_checkpoint(ckpt_path, map_location="cpu")
    tree = read_flax_msgpack(ckpt_path)
    if "memory" not in tree:
        return {"params": flax_to_state_dict(tree)}, load_meta(ckpt_path)
    memory = {k: torch.from_numpy(np.array(v))
              for k, v in tree["memory"].items()}
    return ({"params": flax_to_state_dict(tree["params"]), "memory": memory},
            load_meta(ckpt_path))


def load_base(ckpt_path: str, device=None,
              compute_dtype: torch.dtype = torch.bfloat16,
              trainable: bool = False) -> LoadedBase:
    """The base of ``ckpt_path`` on ``device`` (CUDA unless
    ``device="cpu"``): frozen (no parameter requires a gradient, eval
    form), or with ``trainable`` every parameter requiring one.
    ``compute_dtype`` is the attention projections' type of a TGN or a
    TGAT, bf16 as in the JAX package (a GraphMixer is float32)."""
    dev = resolve_device(device)
    blob, meta = read_base_checkpoint(ckpt_path)
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
                     pos_seq_len=meta.get("pos_seq_len", 1024),
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
                mean_time_shift=meta.get("mean_time_shift", (0.0, 0.0)),
                std_time_shift=meta.get("std_time_shift", (1.0, 1.0)),
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
