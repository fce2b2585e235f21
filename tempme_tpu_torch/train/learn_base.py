"""Base-model training driver; the port runs the TGN path.

Usage:
    python -m tempme_tpu_torch.train.learn_base --data wikipedia \
        --data_dir processed --base_type tgn --n_epoch 5 --bs 256

Port of ``tempme_tpu/train/learn_base.py:33-45,117-137``: the flags, the
one resolved Config, ``write_results``, and the dispatch to the TGN driver
(``learn_tgn.main``). TGAT and GraphMixer are not ported yet and raise,
naming their ROADMAP items. Runs on the CUDA device unless the caller
passes ``device="cpu"`` to ``main``.
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp

from ..config import add_common_args, add_model_args, config_from_args

_NOT_PORTED = {"tgat": "A10", "graphmixer": "A11"}


def write_results(results_dir: str, name: str, payload: dict) -> str:
    os.makedirs(results_dir, exist_ok=True)
    out = osp.join(results_dir, name + ".json")
    with open(out, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"results -> {out}")
    return out


def main(argv=None, device=None):
    p = argparse.ArgumentParser("tempme_tpu_torch base-model training")
    add_common_args(p, bs=256, n_epoch=20, lr=1e-3)
    add_model_args(p)
    p.add_argument("--out_dir", type=str, default="params_torch/tgnn")
    p.add_argument("--resume", action="store_true",
                   help="continue from the .train_state checkpoint if present "
                        "(params, Adam state, generator, memory, early stop)")
    args = p.parse_args(argv)
    cfg = config_from_args(args)
    args.n_degree = cfg.model.n_degree
    if args.base_type in _NOT_PORTED:
        raise NotImplementedError(
            f"base_type {args.base_type} is not ported yet (ROADMAP item "
            f"{_NOT_PORTED[args.base_type]})")
    if args.base_type != "tgn":
        raise ValueError(f"unknown base_type {args.base_type}")
    from .learn_tgn import main as tgn_main
    return tgn_main(args, cfg, device=device)


if __name__ == "__main__":
    main()
