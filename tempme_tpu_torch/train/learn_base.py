"""Base-model training and evaluation driver: TGN, TGAT and GraphMixer.

Usage:
    python -m tempme_tpu_torch.train.learn_base --data wikipedia \
        --data_dir processed --base_type tgat --n_epoch 5
    python -m tempme_tpu_torch.train.learn_base ... --eval_only

Port of ``tempme_tpu/train/learn_base.py``: the flags, the one resolved
Config (a 3-layer TGAT trains at batch 32 unless ``--bs`` is given), the
dispatch of a TGN to its driver (``learn_tgn.main``), the stateless-base
driver (TGAT and GraphMixer: the epoch loop, val and test with a fresh
support sampler, the best checkpoint by val AP, a train-state checkpoint
each epoch and every ``--ckpt_every_steps`` steps, ``--resume``, early
stopping, the results JSON) and ``--eval_only``, which scores a saved base
on the test split and writes the same results file. As in the JAX package,
a TGN's ``--eval_only`` scores test straight from the checkpoint's
train-side memory, while its training run scores test after val has
advanced the memory; so the two test numbers differ. A GraphMixer trains
``--n_layer`` mixer blocks over 2-hop supports whose hop 0 it reads, and
its checkpoint meta's ``n_layer`` is that block count. Every variant flag
trains (``--agg_method``, ``--attn_mode``, ``--use_time`` for a TGAT, whose
meta carries them with ``pos_seq_len``; ``--memory_updater``,
``--aggregator``, ``--message_function``, ``--embedding_module`` for a TGN),
and ``--eval_only`` rebuilds the variant from the meta. Runs on the CUDA
device unless the caller passes ``device="cpu"`` to ``main``.
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import time

import numpy as np
import torch

from ..config import (add_common_args, add_model_args, config_from_args,
                      resolve_bs)
from ..data.events import RandEdgeSampler, load_dataset
from ..data.graph import build_temporal_graph
from ..models.common import Features
from ..utils import metrics as M
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.devices import resolve_device
from ..utils.logging import MetricsLogger
from . import loops

BASES = ("tgn", "tgat", "graphmixer")


def write_results(results_dir: str, name: str, payload: dict) -> str:
    os.makedirs(results_dir, exist_ok=True)
    out = osp.join(results_dir, name + ".json")
    with open(out, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"results -> {out}")
    return out


def evaluate(eval_step: loops.BaseEvalStep, events, batch_size: int,
             seed: int = 0, draws=None) -> dict:
    """AP, AUC and accuracy of a stateless base over a split, in time
    order, padded rows of the last batch left out. ``draws`` is an optional
    iterable of ``SupportDraws``, one per batch; by default they come from
    a ``torch.Generator`` seeded with ``seed`` on the graph's device."""
    dev = eval_step.g.device
    if draws is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        draws = iter(lambda: eval_step.draw(gen, batch_size), None)
    draws = iter(draws)
    scores, masks = [], []
    for batch in loops.iter_batches(events, batch_size,
                                    drop_remainder=False, device=dev):
        pos, neg = eval_step(batch, next(draws))
        scores.append(torch.stack([torch.sigmoid(pos), torch.sigmoid(neg)]))
        masks.append(batch.mask)
    s = torch.stack(scores).cpu().numpy()          # [K, 2, B]
    m = torch.stack(masks).cpu().numpy()           # [K, B]
    labels = np.broadcast_to(np.array([1.0, 0.0])[None, :, None], s.shape)
    m2 = np.broadcast_to(m[:, None, :], s.shape)
    return dict(ap=M.average_precision_score(labels, s, m2),
                auc=M.roc_auc_score(labels, s, m2),
                acc=M.accuracy_score(labels, s, mask=m2))


def _graphs_and_feats(cfg, dev):
    ds = load_dataset(cfg.data.name, cfg.data.data_dir)
    nn_, ne = ds.full.num_nodes, ds.full.num_edges
    g_train = build_temporal_graph(ds.train, nn_, ne, device=dev)
    g_full = build_temporal_graph(ds.full, nn_, ne, device=dev)
    feats = Features(torch.from_numpy(ds.node_feat).to(dev),
                     torch.from_numpy(ds.edge_feat).to(dev))
    test_sampler = RandEdgeSampler([ds.train.src, ds.val.src, ds.test.src],
                                   [ds.train.dst, ds.val.dst, ds.test.dst])
    return (ds, g_train, g_full, feats,
            torch.from_numpy(test_sampler.dst_list).to(dev))


def eval_checkpoint(args, cfg, device=None) -> dict:
    """Score the saved base ``{out_dir}/{base_type}_{data}.pt`` on the test
    split at ``--bs`` (AP, AUC, accuracy; the same support draws as the
    training run's test; a TGN from the checkpoint's memory, with no val
    pass first, as the JAX package's ``eval_checkpoint``) and write
    ``base_{base_type}_{data}.json``."""
    from .base_loader import load_base
    dev = resolve_device(device)
    ds, _, g_full, feats, dst = _graphs_and_feats(cfg, dev)
    base = load_base(osp.join(args.out_dir,
                              f"{args.base_type}_{cfg.data.name}.pt"),
                     device=dev)
    n, bs = int(base.meta["n_degree"]), cfg.train.batch_size
    if base.base_type == "tgn":
        from .learn_tgn import evaluate_tgn, make_tgn_eval_step
        eval_step = make_tgn_eval_step(base.model, g_full, feats, dst, n)
        test, _ = evaluate_tgn(eval_step, base.memory, ds.test, bs)
    else:
        eval_step = loops.make_base_eval_step(
            base.model, g_full, feats, dst,
            support_hops(base.base_type, int(base.meta["n_layer"])), n)
        test = evaluate(eval_step, ds.test, bs)
    print(f"[eval {args.base_type}/{cfg.data.name}] ap={test['ap']:.4f} "
          f"auc={test['auc']:.4f} acc={test['acc']:.4f}")
    write_results(args.results_dir, f"base_{args.base_type}_{cfg.data.name}",
                  dict(base_type=args.base_type, data=cfg.data.name, **test))
    return test


def support_hops(base_type: str, n_layer: int) -> int:
    """The depth of a stateless base's supports: a TGAT's ``n_layer``; a
    GraphMixer samples 2 hops, as the JAX package does, and reads hop 0."""
    return n_layer if base_type == "tgat" else 2


def build_model(mc, node_dim: int, edge_dim: int, device, seed: int):
    """The stateless base of ``mc`` (TGAT or GraphMixer)."""
    if mc.base_type == "graphmixer":
        from ..models.graphmixer import GraphMixer
        return GraphMixer(node_dim=node_dim, edge_dim=edge_dim,
                          num_tokens=mc.n_degree, num_layers=mc.n_layers,
                          token_expansion=mc.token_expansion,
                          channel_expansion=mc.channel_expansion,
                          dropout=mc.dropout, device=device, seed=seed)
    from ..models.tgat import TGAT
    # 3-layer supports (n + n**2 + n**3 events a side) train within one
    # card's memory with each attn/prod block recomputed in the backward;
    # "pos" ranks each parent's n children, so n_degree rows suffice
    return TGAT(node_dim=node_dim, edge_dim=edge_dim,
                num_layers=mc.n_layers, n_head=mc.n_heads,
                dropout=mc.dropout, agg_method=mc.agg_method,
                attn_mode=mc.attn_mode, use_time=mc.use_time,
                pos_seq_len=max(64, mc.n_degree),
                remat=mc.n_layers >= 3, device=device, seed=seed)


def _stateless_main(args, cfg, device=None):
    """The TGAT and GraphMixer training driver. Returns the best
    checkpoint's test AP."""
    dev = resolve_device(device)
    mc, bs = cfg.model, cfg.train.batch_size
    k = support_hops(mc.base_type, mc.n_layers)
    ds, g_train, g_full, feats, dst_test = _graphs_and_feats(cfg, dev)
    model = build_model(mc, ds.node_feat.shape[1], ds.edge_feat.shape[1],
                        dev, cfg.train.seed)
    train_sampler = RandEdgeSampler([ds.train.src], [ds.train.dst])
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model={args.base_type} data={cfg.data.name} "
          f"params={n_params:,} n_degree={mc.n_degree} "
          f"layers={mc.n_layers} bs={bs} device={dev}")

    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.train.lr)
    generator = torch.Generator(device=dev)
    generator.manual_seed(cfg.train.seed)
    state = loops.TrainState(model, optimizer, generator)
    train_step = loops.make_base_train_step(
        model, g_train, feats,
        torch.from_numpy(train_sampler.dst_list).to(dev), k, mc.n_degree,
        optimizer)
    eval_step = loops.make_base_eval_step(model, g_full, feats, dst_test, k,
                                          mc.n_degree)

    stopper = M.EarlyStopMonitor(max_round=args.patience)
    best = None
    os.makedirs(args.out_dir, exist_ok=True)
    ckpt_path = osp.join(args.out_dir, f"{args.base_type}_{cfg.data.name}.pt")
    train_ckpt = ckpt_path + ".train_state"
    start_epoch, start_step = 0, 0
    if args.resume and osp.exists(train_ckpt):
        blob, tmeta = load_checkpoint(train_ckpt, map_location="cpu")
        state.load_state_dict(blob)
        best = tmeta["best"]
        stopper.load_state_dict(tmeta["stopper"])
        if tmeta.get("step", -1) >= 0:   # mid-epoch (--ckpt_every_steps)
            start_epoch, start_step = tmeta["epoch"], tmeta["step"]
            print(f"resumed from {train_ckpt} at epoch {start_epoch} "
                  f"step {start_step}")
        else:
            start_epoch = tmeta["epoch"] + 1
            print(f"resumed from {train_ckpt} at epoch {start_epoch}")
    logger = MetricsLogger(args.log_dir, run_name=time.strftime(
        f"{args.base_type}_{cfg.data.name}_%Y%m%d_%H%M%S"))
    for epoch in range(start_epoch, cfg.train.n_epoch):
        t0 = time.time()
        batches = loops.stack_batches(ds.train, bs, shuffle=True,
                                      seed=cfg.train.seed + epoch, device=dev)
        n_batches = batches.src.shape[0]
        first = start_step if epoch == start_epoch else 0
        if first:
            print(f"  (mid-epoch resume: skipping {first} completed "
                  f"steps; epoch metrics cover the remainder)")
        auxs = []
        for i in range(first, n_batches):
            batch = loops.Batch(*(x[i] for x in batches))
            auxs.append(train_step(batch, train_step.draw(generator, bs)))
            if args.ckpt_every_steps and \
                    (i + 1) % args.ckpt_every_steps == 0 and \
                    i + 1 < n_batches:
                save_checkpoint(train_ckpt, state.state_dict(),
                                meta=dict(epoch=epoch, step=i + 1, best=best,
                                          stopper=stopper.state_dict()))
        losses, pos, neg = (torch.stack([a[key] for a in auxs]).cpu().numpy()
                            for key in ("loss", "pos", "neg"))
        dt = time.time() - t0
        pos, neg = 1 / (1 + np.exp(-pos)), 1 / (1 + np.exp(-neg))
        n_events = losses.shape[0] * bs
        labels = np.r_[np.ones(bs), np.zeros(bs)]
        aps = [M.average_precision_score(labels, np.r_[p, q])
               for p, q in zip(pos, neg)]
        # selection and early stop on val; test is reported only
        val = evaluate(eval_step, ds.val, bs)
        test = evaluate(eval_step, ds.test, bs)
        print(f"epoch {epoch}: loss={np.mean(losses):.4f} "
              f"train_ap={np.mean(aps):.4f} val_ap={val['ap']:.4f} "
              f"test_ap={test['ap']:.4f} test_auc={test['auc']:.4f} "
              f"({n_events / dt:,.0f} events/s)")
        for i, loss in enumerate(losses):
            logger.add_scalar("Train/step_loss", float(loss),
                              epoch * n_batches + first + i)
        logger.add_scalars("Train", {"loss": float(np.mean(losses)),
                                     "ap": float(np.mean(aps)),
                                     "events_per_s": n_events / dt}, epoch)
        logger.add_scalars("Val", val, epoch)
        logger.add_scalars("Test", test, epoch)
        logger.flush()
        if best is None or val["ap"] > best.get("val_ap", float("-inf")):
            best = dict(test, val_ap=val["ap"])
            # n_layer: a TGAT's layers, a GraphMixer's mixer blocks (what
            # both packages' loaders build)
            meta = dict(base_type=args.base_type, data=cfg.data.name,
                        n_degree=mc.n_degree, n_layer=mc.n_layers,
                        n_head=mc.n_heads, drop_out=mc.dropout,
                        node_dim=ds.node_feat.shape[1],
                        edge_dim=ds.edge_feat.shape[1])
            if args.base_type == "tgat":
                meta.update(agg_method=mc.agg_method,
                            attn_mode=mc.attn_mode, use_time=mc.use_time,
                            pos_seq_len=max(64, mc.n_degree))
            save_checkpoint(ckpt_path, {"params": model.state_dict()},
                            meta=meta)
            print(f"  saved best checkpoint -> {ckpt_path} "
                  f"(val_ap={best['val_ap']:.4f} test_ap={best['ap']:.4f})")
        stop = stopper.early_stop_check(val["ap"])
        save_checkpoint(train_ckpt, state.state_dict(),
                        meta=dict(epoch=epoch, best=best,
                                  stopper=stopper.state_dict()))
        if stop:
            print(f"early stop at epoch {epoch}")
            break
    logger.close()
    if best is not None:
        write_results(args.results_dir,
                      f"base_{args.base_type}_{cfg.data.name}",
                      dict(base_type=args.base_type, data=cfg.data.name,
                           **best))
    return 0.0 if best is None else best["ap"]


def main(argv=None, device=None):
    p = argparse.ArgumentParser("tempme_tpu_torch base-model training")
    add_common_args(p, bs=256, n_epoch=20, lr=1e-3)
    add_model_args(p)
    p.add_argument("--out_dir", type=str, default="params_torch/tgnn")
    p.add_argument("--eval_only", action="store_true",
                   help="evaluate the saved checkpoint on the test split")
    p.add_argument("--resume", action="store_true",
                   help="continue from the .train_state checkpoint if present "
                        "(params, Adam state, generator, early stop; the "
                        "TGN's memory)")
    args = p.parse_args(argv)
    resolve_bs(args, deep_tgat_bs=32)
    cfg = config_from_args(args)
    args.n_degree = cfg.model.n_degree
    if args.base_type not in BASES:
        raise ValueError(f"unknown base_type {args.base_type}")
    if args.eval_only:
        return eval_checkpoint(args, cfg, device=device)
    if args.base_type == "tgn":
        from .learn_tgn import main as tgn_main
        return tgn_main(args, cfg, device=device)
    return _stateless_main(args, cfg, device=device)


if __name__ == "__main__":
    main()
