"""Carry flax TGN, TGAT, GraphMixer, TempME and TempMETGAT weights across
into the port's ``state_dict``.

The input is a flax parameter tree as nested dicts of numpy arrays (with or
without the outer ``{"params": ...}``); ``read_flax_msgpack`` reads one
from a checkpoint the JAX package wrote (flax's msgpack format) without
flax or a msgpack package. The rules:

* a ``Dense`` kernel ``[in, out]`` becomes ``Linear.weight`` ``[out, in]``;
* ``LayerNorm`` ``scale``/``bias`` become ``weight``/``bias``;
* ``TimeEncode`` ``freq``/``phase`` carry over as they are;
* ``attn_{i}`` becomes ``attn_layers.{i}``, ``mixer_{i}`` (a GraphMixer's
  blocks) ``mixers.{i}``, ``nn.Sequential``'s
  ``layers_{j}`` becomes ``{j}``, and flax's auto-named ``Dense_{j}`` (the
  explainer's ``EventGCN`` and motif attention, the TGAT explainer's
  encoder layers) becomes ``fc{j+1}``, ``LayerNorm_{j}`` ``norm{j+1}``;
* ``MultiHeadDotProductAttention``'s ``DenseGeneral`` kernels (the TGAT
  explainer's ``self_attn``) are 3-D: ``query``/``key``/``value``
  ``[in, heads, head_dim]`` become ``weight [heads * head_dim, in]``,
  ``out`` ``[heads, head_dim, out]`` becomes ``weight [out, heads *
  head_dim]``, and the ``[heads, head_dim]`` biases are flattened;
* a TGAT's ``attn_{i}`` holds its eight bias-free projections, ``fc``,
  ``ln`` and the gated ``merger`` (``fc11`` ... ``fc22``), beside
  ``time_encoder`` and ``affinity_score``: the rules above map it whole;
* a GraphMixer's blocks hold ``token_norm``/``channel_norm`` and the
  ``token_ffn``/``channel_ffn`` feed-forwards, whose auto-named
  ``Dense_0``/``Dense_1`` become ``fc1``/``fc2``; its frozen time encoder
  has no entry on either side;
* flax's ``GRUCell`` has dense layers ``ir``/``iz``/``in`` with bias and
  ``hr``/``hz`` without (``hn`` has one). The port's ``models/tgn.py``
  ``GRUCell`` has the same parameters, stacked: ``weight_ih = cat(ir, iz,
  in)^T``, ``bias_ih = cat(b_ir, b_iz, b_in)``, ``weight_hh = cat(hr, hz,
  hn)^T`` and ``bias_hn = b_hn`` (the JAX call is
  ``memory_cell(carry=memory, inputs=msgs)``, the port's
  ``memory_updater(msgs, memory)``); flax's ``SimpleCell`` (the ``rnn``
  updater: ``i`` with bias, ``h`` without) maps by the rules above;
* the TGAT variants: a map-attention block holds ``map_attn`` (the
  bias-free ``wq/wk/wv_node_transform``, ``fc``, ``ln`` and the
  ``[d_k, 1]`` ``weight_map_q``/``weight_map_k``, which become ``[d_k]``)
  beside its ``merger``; an LSTM block's cell (``OptimizedLSTMCell_0``)
  has bias-free input kernels ``ii``/``if``/``ig``/``io`` and hidden
  kernels ``hi``/``hf``/``hg``/``ho`` with bias, stacked as
  ``lstm.weight_ih = cat(ii, if, ig, io)^T``, ``lstm.weight_hh = cat(hi,
  hf, hg, ho)^T``, ``lstm.bias_hh``; ``time_encoder/pos_table`` keeps its
  ``[seq_len, dim]`` shape; a Jodie TGN's ``jodie_proj`` is a ``Dense``.

An enhance checkpoint of the JAX package holds the predictor and the base
it trained, ``{"predictor": {"params"}, "base": {"params"}}``, for a TGN
or a GraphMixer, and the ``TempMETGAT`` predictor alone, ``{"params"}``,
for a TGAT; ``enhance_state_dicts`` splits it. Its meta gives the
predictor's ``out_dim`` and ``hid_dim``; a GraphMixer base's block count
is the tree's own (``mixer_blocks``), which may be fewer than the base
checkpoint's meta says (the JAX loader drops blocks its meta lacks).

On a mesh with a ``tp`` axis the sharded TGN step holds a block of rows of
the weights that JAX's ``shard_params_tp`` shards (``tp_sharded_names``);
``tp_shard_state_dict`` cuts a rank's block out of a whole state dict and
``tp_unshard_state_dict`` joins the blocks again.
"""
from __future__ import annotations

import re
import struct

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


def _lstm(tree: dict, prefix: str, out: dict) -> None:
    gates = ("i", "f", "g", "o")
    out[prefix + "weight_ih"] = _t(np.concatenate(
        [np.asarray(tree["i" + g]["kernel"]) for g in gates], axis=1).T)
    out[prefix + "weight_hh"] = _t(np.concatenate(
        [np.asarray(tree["h" + g]["kernel"]) for g in gates], axis=1).T)
    out[prefix + "bias_hh"] = _t(np.concatenate(
        [tree["h" + g]["bias"] for g in gates]))


def _module_name(name: str) -> str:
    m = re.fullmatch(r"(attn|mixer)_(\d+)", name)
    if m:
        stem = "attn_layers" if m.group(1) == "attn" else "mixers"
        return f"{stem}.{m.group(2)}"
    m = re.fullmatch(r"(Dense|LayerNorm)_(\d+)", name)
    if m:
        stem = "fc" if m.group(1) == "Dense" else "norm"
        return f"{stem}{int(m.group(2)) + 1}"
    m = re.fullmatch(r"layers_(\d+)", name)
    return m.group(1) if m else name


def _walk(tree: dict, prefix: str, out: dict) -> None:
    for name, val in tree.items():
        if name == "memory_updater" and "ir" in val:
            _gru(val, prefix + "memory_updater.", out)
        elif name == "OptimizedLSTMCell_0":
            _lstm(val, prefix + "lstm.", out)
        elif name == "pos_table":
            out[prefix + name] = _t(val)
        elif isinstance(val, dict):
            _walk(val, prefix + _module_name(name) + ".", out)
        elif name == "kernel":
            k = np.asarray(val)
            if k.ndim == 3:                    # attention's DenseGeneral
                k = k.reshape(-1, k.shape[2]) if prefix.endswith("out.") \
                    else k.reshape(k.shape[0], -1)
            out[prefix + "weight"] = _t(k.T)
        elif name == "scale":
            out[prefix + "weight"] = _t(val)
        else:                                  # bias, freq, phase
            out[prefix + name] = _t(np.asarray(val).reshape(-1))


def flax_to_state_dict(params: dict) -> dict:
    """Flax parameter tree of a TGN, a TGAT, a GraphMixer, or a TempME or
    TempMETGAT explainer (or of one of their submodules) -> the
    matching port module's ``state_dict`` as CPU float32 tensors (load it
    with ``module.load_state_dict``)."""
    if set(params) == {"params"}:
        params = params["params"]
    out: dict = {}
    _walk(params, "", out)
    return out


def enhance_state_dicts(tree: dict) -> dict:
    """A JAX enhance checkpoint's tree -> ``{"predictor": state_dict}``,
    plus ``"base"`` for a TGN or a GraphMixer."""
    if set(tree) == {"predictor", "base"}:
        return {k: flax_to_state_dict(tree[k]) for k in ("predictor", "base")}
    return {"predictor": flax_to_state_dict(tree)}


def mixer_blocks(state_dict: dict) -> int:
    """The number of mixer blocks a GraphMixer ``state_dict`` holds."""
    return len({k.split(".")[1] for k in state_dict
                if k.startswith("mixers.")})


# the port's stacked recurrent weights: flax's per-gate kernels, each
# [in, hidden], stacked on the torch weight's dim 0
_GATES = {"memory_updater.weight_ih": 3, "memory_updater.weight_hh": 3,
          "lstm.weight_ih": 4, "lstm.weight_hh": 4}


def tp_sharded_names(shapes: dict, tp: int) -> list:
    """The port's parameters that JAX's ``shard_params_tp``
    (``tempme_tpu/parallel/mesh.py``) shards over ``tp``, by name, from
    ``{name: shape}`` (a ``state_dict``'s): a flax ``Dense`` kernel ``[in,
    out]`` with ``out % tp == 0`` and ``out >= 2 tp``, the torch weight
    ``[out, in]`` cut on dim 0; a stacked GRU or LSTM weight is sharded
    where its gates' kernels are (``out`` a gate's width). Biases and other
    1-D tensors, a TGAT's ``pos_table`` and the 3-D ``DenseGeneral``
    kernels of the TGAT explainer's ``self_attn`` stay whole, as in JAX
    (``pos_table``'s sharded axis there is its last, which the port's TGN
    steps never meet)."""
    out = []
    for name, shape in shapes.items():
        if tp <= 1 or len(shape) != 2 or "self_attn." in name or \
                name.endswith("pos_table"):
            continue
        gates = next((g for k, g in _GATES.items() if name.endswith(k)), 1)
        width = shape[0] // gates
        if width % tp == 0 and width >= 2 * tp:
            out.append(name)
    return out


def tp_shard_state_dict(state_dict: dict, tp: int, index: int,
                        names=None) -> dict:
    """Rank ``index``'s entries of a whole ``state_dict`` (such as
    ``flax_to_state_dict``'s) on a tp axis of ``tp``: each tensor of
    ``names`` (default ``tp_sharded_names``) cut to its ``index``-th block
    of dim-0 rows, every other entry as it is."""
    if names is None:
        names = tp_sharded_names({k: tuple(v.shape)
                                  for k, v in state_dict.items()}, tp)
    out = dict(state_dict)
    for k in names:
        rows = state_dict[k].shape[0] // tp
        out[k] = state_dict[k][index * rows:(index + 1) * rows]
    return out


def tp_unshard_state_dict(parts, names) -> dict:
    """The inverse of ``tp_shard_state_dict``: every tp rank's entries (in
    rank order) -> the whole ``state_dict``, the tensors of ``names``
    concatenated on dim 0, every other entry rank 0's."""
    out = dict(parts[0])
    for k in names:
        out[k] = torch.cat([p[k] for p in parts])
    return out


class _Reader:
    """The subset of msgpack that flax's checkpoints use: maps, arrays,
    strings, binaries, unsigned integers (array shapes), and flax's
    extension 1 (an ndarray packed as [shape, dtype name, C-order bytes])
    and 3 (a numpy scalar, packed the same way)."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def take(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def ext(self, code: int, size: int):
        payload = _Reader(self.take(size)).read()
        if code not in (1, 3):
            raise ValueError(f"msgpack extension {code} is not a flax array")
        shape, dtype, raw = payload
        arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
        return arr.copy() if code == 1 else arr[()]

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.read() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self.take(b & 0x1f).decode()
        sized = {0xc4: "B", 0xc5: "H", 0xc6: "I", 0xd9: "B", 0xda: "H",
                 0xdb: "I"}
        if b in sized:
            raw = self.take(self.unpack(sized[b]))
            return raw if b <= 0xc6 else raw.decode()
        unsigned = {0xcc: "B", 0xcd: "H", 0xce: "I", 0xcf: "Q"}
        if b in unsigned:
            return self.unpack(unsigned[b])
        if b in (0xdc, 0xdd):
            return [self.read()
                    for _ in range(self.unpack("H" if b == 0xdc else "I"))]
        if b in (0xde, 0xdf):
            return self.map(self.unpack("H" if b == 0xde else "I"))
        if 0xd4 <= b <= 0xd8:
            code = self.unpack("b")
            return self.ext(code, 1 << (b - 0xd4))
        if b in (0xc7, 0xc8, 0xc9):
            size = self.unpack({0xc7: "B", 0xc8: "H", 0xc9: "I"}[b])
            return self.ext(self.unpack("b"), size)
        raise ValueError(f"msgpack type byte {b:#x} is not supported")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def read_flax_msgpack(path: str) -> dict:
    """A flax checkpoint (``flax.serialization.to_bytes``) as nested dicts
    of numpy arrays. Arrays that flax split into chunks (leaves above 1 GiB)
    are refused."""
    with open(path, "rb") as f:
        reader = _Reader(f.read())
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"{path}: trailing bytes after the msgpack object")

    def check(node):
        if isinstance(node, dict):
            if "__msgpack_chunked_array__" in node:
                raise ValueError(f"{path}: chunked arrays are not supported")
            for v in node.values():
                check(v)
    check(tree)
    return tree
