"""Carry flax TGN and TempME weights across into the port's
``state_dict``.

The input is a flax parameter tree as nested dicts of numpy arrays (with or
without the outer ``{"params": ...}``). The rules:

* a ``Dense`` kernel ``[in, out]`` becomes ``Linear.weight`` ``[out, in]``;
* ``LayerNorm`` ``scale``/``bias`` become ``weight``/``bias``;
* ``TimeEncode`` ``freq``/``phase`` carry over as they are;
* ``attn_{i}`` becomes ``attn_layers.{i}``, ``nn.Sequential``'s
  ``layers_{j}`` becomes ``{j}``, and flax's auto-named ``Dense_{j}`` (the
  explainer's ``EventGCN`` and motif attention) becomes ``fc{j+1}``;
* flax's ``GRUCell`` has dense layers ``ir``/``iz``/``in`` with bias and
  ``hr``/``hz`` without (``hn`` has one). The port's ``models/tgn.py``
  ``GRUCell`` has the same parameters, stacked: ``weight_ih = cat(ir, iz,
  in)^T``, ``bias_ih = cat(b_ir, b_iz, b_in)``, ``weight_hh = cat(hr, hz,
  hn)^T`` and ``bias_hn = b_hn`` (the JAX call is
  ``memory_cell(carry=memory, inputs=msgs)``, the port's
  ``memory_updater(msgs, memory)``).
"""
from __future__ import annotations

import re

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _gru(tree: dict, prefix: str, out: dict) -> None:
    def kern(name):
        return np.asarray(tree[name]["kernel"], np.float32)
    out[prefix + "weight_ih"] = _t(np.concatenate(
        [kern("ir"), kern("iz"), kern("in")], axis=1).T)
    out[prefix + "bias_ih"] = _t(np.concatenate(
        [tree[g]["bias"] for g in ("ir", "iz", "in")]))
    out[prefix + "weight_hh"] = _t(np.concatenate(
        [kern("hr"), kern("hz"), kern("hn")], axis=1).T)
    out[prefix + "bias_hn"] = _t(tree["hn"]["bias"])


def _module_name(name: str) -> str:
    m = re.fullmatch(r"attn_(\d+)", name)
    if m:
        return f"attn_layers.{m.group(1)}"
    m = re.fullmatch(r"Dense_(\d+)", name)
    if m:
        return f"fc{int(m.group(1)) + 1}"
    m = re.fullmatch(r"layers_(\d+)", name)
    return m.group(1) if m else name


def _walk(tree: dict, prefix: str, out: dict) -> None:
    for name, val in tree.items():
        if name == "memory_updater":
            _gru(val, prefix + "memory_updater.", out)
        elif isinstance(val, dict):
            _walk(val, prefix + _module_name(name) + ".", out)
        elif name == "kernel":
            out[prefix + "weight"] = _t(np.asarray(val).T)
        elif name == "scale":
            out[prefix + "weight"] = _t(val)
        else:                                  # bias, freq, phase
            out[prefix + name] = _t(val)


def flax_to_state_dict(params: dict) -> dict:
    """Flax parameter tree of a TGN or a TempME explainer (or of one of
    their submodules) -> the
    matching port module's ``state_dict`` as CPU float32 tensors (load it
    with ``module.load_state_dict``)."""
    if set(params) == {"params"}:
        params = params["params"]
    out: dict = {}
    _walk(params, "", out)
    return out
