"""The enhance stage: motif-enhanced link prediction, trained jointly with
the base it reads.

Usage:
    python -m tempme_tpu_torch.train.enhance_main --data wikipedia \
        --data_dir processed --base_type tgn --n_epoch 10 --bs 100

Port of ``tempme_tpu/train/enhance_main.py``. For a TGN or a GraphMixer
the TempME explainer, fresh, becomes a predictor: per train step the
negatives, the three 2-hop supports (``sample_rows``) and the three sides'
motif walks (``sample_union``, ``sample_masked``) are sampled on the card;
the base (``{ckpt_dir}/tgnn/{base_type}_{data}.pt``, loaded strictly and
trainable) embeds src, tgt and the negative in its training form (a TGN's
attention through ``attend_drop``, its memory advanced and its messages
stored detached); ``TempME.enhance_predict_agg`` joins each side's walk
embedding with the base's node embedding and scores the two pairs; one
Adam step (AdamW with ``--weight_decay``, which decays the predictor
alone) goes over predictor and base on the BCE of the true labels, the
gradient reaching the base through its backward (``attend_bwd``). With
``--freeze_base_epochs K`` the base's gradients are zeros for the first K
epochs (not absent: Adam keeps one step count over both models, as optax
does over its tree). The TGN's memory runs on across epochs; each epoch
ends with val, then test, the memory carried through both and then set
back. The best checkpoint is chosen on val AP (strictly greater), a
train-state checkpoint (both models, the optimizer, the generator, a
TGN's memory) is written every epoch and ``--resume`` continues from it.

For a TGAT the predictor is ``TempMETGAT`` on the walks alone, the base
is not read (its checkpoint's meta gives ``n_degree`` when there is
one), the best checkpoint is chosen on test AP and no train state is
written, as in the JAX package.

Eval batches are padded with the split's first event and read through
the mask; as in the JAX package the padded rows enter the walk weights'
batch statistics and, for a TGN, the eval memory. Every random number
comes from one ``torch.Generator`` (``loops.draw_enhance``), saved with
the train state so that a resumed run is the uninterrupted one; eval
draws come from a generator seeded 999 per split. Runs on the CUDA device
unless a Python caller passes ``device="cpu"`` to ``main``.
"""
from __future__ import annotations

import argparse
import os.path as osp
import time

import numpy as np
import torch

from ..config import add_common_args, add_explainer_args, config_from_args
from ..data.events import RandEdgeSampler, load_dataset
from ..data.graph import build_temporal_graph
from ..explain.tempme import TempME
from ..explain.tempme_tgat import TempMETGAT
from ..models.common import Features
from ..models.tgn import TGNMemoryState
from ..tools.node_degrees import compute_node_degrees
from ..utils import metrics as M
from ..utils.checkpoint import load_checkpoint, load_meta, save_checkpoint
from ..utils.devices import resolve_device
from ..utils.logging import MetricsLogger
from . import loops
from .base_loader import LoadedBase, load_base
from .learn_base import write_results
from .temp_exp_main import N_WALK_CONT, sample_explainer_inputs

EVAL_SEED = 999


def enhance_loss(pos, neg):
    """BCE of the positive logits against 1 plus the negatives' against
    0, each a mean over the batch."""
    bce = torch.nn.functional.binary_cross_entropy_with_logits
    return bce(pos, torch.ones_like(pos)) + bce(neg, torch.zeros_like(neg))


class _Steps:
    """What the train and eval steps share: the predictor, the base (None
    for a TGAT), the graph, the features, the negatives' table, the support
    width and the degree table."""

    def __init__(self, predictor, base: LoadedBase | None, g, feats,
                 dst_table, n_degree: int, node_degree):
        self.predictor, self.base, self.g = predictor, base, g
        self.feats, self.dst_table, self.n = feats, dst_table, n_degree
        self.node_degree = node_degree
        self.is_tgn = base is not None and base.base_type == "tgn"

    def _draw(self, generator, batch_size, training):
        return loops.draw_enhance(
            generator, batch_size, self.n, N_WALK_CONT,
            self.dst_table.shape[0], self.g.device,
            base=self.base.model if training and self.base else None,
            predictor=self.predictor if training else None)

    def sample(self, batch, draws: loops.EnhanceDraws):
        """The batch's ``(bgd, subs, walks)``, sampled from ``draws``."""
        return sample_explainer_inputs(self.g, batch, self.dst_table, self.n,
                                       draws)

    def _forward(self, mem, batch, draws: loops.EnhanceDraws, train_base,
                 inputs=None, stats=None, exchange=None):
        """((pos [B, 1], neg [B, 1]), new memory or None). Autograd
        records the base only with ``train_base``. ``inputs``: ``sample``'s
        result, or None to sample here; ``stats``: per side the
        predictor's batch statistics, or None (each side's own);
        ``exchange``: as in ``TGN.get_node_emb``."""
        bgd, subs, walks = inputs if inputs is not None else \
            self.sample(batch, draws)
        if self.base is None:
            return self.predictor.enhance_predict_agg(
                self.feats, batch.ts, *walks, self.node_degree,
                draws.pred, stats), None
        with torch.set_grad_enabled(train_base):
            if self.is_tgn:
                embs, mem = self.base.model.get_node_emb(
                    self.feats, mem, batch.src, batch.dst, bgd, batch.ts,
                    batch.eidx, *subs, drop=draws.base, update_memory=True,
                    exchange=exchange)
            else:
                embs = self.base.model.get_node_emb(
                    self.feats, batch.src, batch.dst, bgd, batch.ts, *subs,
                    drop=draws.base)
        return self.predictor.enhance_predict_agg(
            self.feats, batch.ts, *walks, *embs, self.node_degree,
            draws.pred, stats), mem


class EnhanceTrainStep(_Steps):
    """``step(mem, batch, draws, train_base=True) -> (new_mem, {"loss",
    "pos", "neg"})``: one optimizer step over the predictor and the base
    (``train_base=False``: the base runs without autograd and its
    gradients are zeros). The gradients stay in the parameters' ``.grad``
    until the next step; the memory (a TGN's, else None) comes back
    detached."""

    def __init__(self, predictor, base, g_train, feats, dst_table, n_degree,
                 node_degree, optimizer: torch.optim.Optimizer):
        super().__init__(predictor, base, g_train, feats, dst_table,
                         n_degree, node_degree)
        self.optimizer = optimizer

    def draw(self, generator: torch.Generator,
             batch_size: int) -> loops.EnhanceDraws:
        return self._draw(generator, batch_size, training=True)

    def zero_missing_grads(self) -> None:
        """optax steps every leaf of its tree: a parameter this step did
        not reach (the frozen base, the explainer's importance head, a
        TGN's affinity head) takes a zero gradient here, not none, so that
        Adam keeps one step count for all and AdamW decays them as optax
        does."""
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)

    @staticmethod
    def finish(new_mem, loss, pos, neg):
        """The step's results: the memory (a TGN's, else None) detached,
        and the aux dict."""
        if new_mem is not None:
            new_mem = type(new_mem)(*(x.detach() for x in new_mem))
        return new_mem, {"loss": loss.detach(),
                         "pos": pos.detach().squeeze(-1),
                         "neg": neg.detach().squeeze(-1)}

    def __call__(self, mem, batch: loops.Batch, draws: loops.EnhanceDraws,
                 train_base: bool = True):
        self.optimizer.zero_grad(set_to_none=True)
        (pos, neg), new_mem = self._forward(mem, batch, draws, train_base)
        loss = enhance_loss(pos, neg)
        loss.backward()
        self.zero_missing_grads()
        self.optimizer.step()
        return self.finish(new_mem, loss, pos, neg)


class EnhanceEvalStep(_Steps):
    """``step(mem, batch, draws) -> (pos [B], neg [B], new_mem)`` in eval
    form (a TGN's memory advanced by the batch)."""

    def draw(self, generator: torch.Generator,
             batch_size: int) -> loops.EnhanceDraws:
        return self._draw(generator, batch_size, training=False)

    @torch.no_grad()
    def __call__(self, mem, batch: loops.Batch, draws: loops.EnhanceDraws):
        (pos, neg), mem = self._forward(mem, batch, draws, False)
        return pos.squeeze(-1), neg.squeeze(-1), mem


def evaluate_enhance(eval_step: EnhanceEvalStep, mem, events,
                     batch_size: int, seed: int = EVAL_SEED):
    """AP and AUC over a split in time order, padded rows of the last batch
    left out of the scores, a TGN's memory carried through the split (the
    caller's ``mem`` is not modified). Returns (ap, auc, new memory)."""
    dev = eval_step.g.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    scores, masks = [], []
    for batch in loops.iter_batches(events, batch_size,
                                    drop_remainder=False, device=dev):
        pos, neg, mem = eval_step(mem, batch,
                                  eval_step.draw(gen, batch_size))
        scores.append(torch.stack([torch.sigmoid(pos), torch.sigmoid(neg)]))
        masks.append(batch.mask)
    s = torch.stack(scores).cpu().numpy()          # [K, 2, B]
    m = torch.stack(masks).cpu().numpy()           # [K, B]
    labels = np.broadcast_to(np.array([1.0, 0.0])[None, :, None], s.shape)
    m2 = np.broadcast_to(m[:, None, :], s.shape)
    return (M.average_precision_score(labels, s, m2),
            M.roc_auc_score(labels, s, m2), mem)


def _train_epoch(train_step, mem, events, bs, seed, generator, dev,
                 train_base=True):
    """One shuffled epoch of full batches: (memory, mean loss, mean of the
    per-batch train APs, events a second on the steps' clock, the step
    losses)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    batches = loops.stack_batches(events, bs, shuffle=True, seed=seed,
                                  device=dev)
    auxs = []
    for i in range(batches.src.shape[0]):
        batch = loops.Batch(*(x[i] for x in batches))
        mem, aux = train_step(mem, batch, train_step.draw(generator, bs),
                              train_base)
        auxs.append(aux)
    losses = torch.stack([a["loss"] for a in auxs]).cpu().numpy()
    pos, neg = (torch.sigmoid(torch.stack([a[k] for a in auxs])).cpu()
                .numpy() for k in ("pos", "neg"))
    dt = time.time() - t0                  # the steps, through their sync
    labels = np.r_[np.ones(bs), np.zeros(bs)]
    aps = [M.average_precision_score(labels, np.r_[p, q])
           for p, q in zip(pos, neg)]
    return (mem, float(np.mean(losses)), float(np.mean(aps)),
            len(auxs) * bs / dt, losses)


def _parse(argv):
    p = argparse.ArgumentParser("tempme_tpu_torch enhance training")
    add_common_args(p, bs=100, n_epoch=10, lr=1e-3)
    add_explainer_args(p)
    p.add_argument("--base_type", type=str, default="tgn")
    p.add_argument("--ckpt_dir", type=str, default="params_torch")
    p.add_argument("--resume", action="store_true",
                   help="resume from the .train_state checkpoint (tgn/"
                        "graphmixer path)")
    p.add_argument("--freeze_base_epochs", type=int, default=0,
                   help="train only the predictor for the first K epochs "
                        "(the base's gradients are zeros; 0 = joint from "
                        "epoch 0)")
    args = p.parse_args(argv)
    if args.ckpt_every_steps:
        raise ValueError("enhance checkpoints its train state once an epoch "
                         "(no --ckpt_every_steps, as in the JAX package)")
    return args


def _data(cfg, dev):
    """The splits, both graphs, the features, the two negatives' tables
    and the degree table, on ``dev``."""
    ds = load_dataset(cfg.data.name, cfg.data.data_dir)
    nn_, ne = ds.full.num_nodes, ds.full.num_edges
    feats = Features(torch.from_numpy(ds.node_feat).to(dev),
                     torch.from_numpy(ds.edge_feat).to(dev))

    def table(*lists):
        return torch.from_numpy(RandEdgeSampler(*lists).dst_list).to(dev)
    return dict(
        ds=ds, feats=feats,
        g_train=build_temporal_graph(ds.train, nn_, ne, device=dev),
        g_full=build_temporal_graph(ds.full, nn_, ne, device=dev),
        dst_train=table([ds.train.src], [ds.train.dst]),
        dst_test=table([ds.train.src, ds.val.src, ds.test.src],
                       [ds.train.dst, ds.val.dst, ds.test.dst]),
        node_degree=torch.from_numpy(compute_node_degrees(ds.full)).to(dev))


def _predictor_meta(args, cfg, ds, n_degree):
    ec = cfg.explainer
    return dict(base_type=args.base_type, data=cfg.data.name,
                out_dim=ec.out_dim, hid_dim=ec.hid_dim, drop_out=ec.dropout,
                n_degree=n_degree, node_dim=ds.node_feat.shape[1],
                edge_dim=ds.edge_feat.shape[1])


def main(argv=None, device=None):
    """The enhance driver. Returns the best checkpoint's test AP."""
    args = _parse(argv)
    cfg = config_from_args(args)
    dev = resolve_device(device)
    if args.base_type == "tgat":
        return _main_tgat(args, cfg, dev)
    if args.base_type not in ("tgn", "graphmixer"):
        raise ValueError(f"unknown base_type {args.base_type}")
    ec, tc = cfg.explainer, cfg.train
    d = _data(cfg, dev)
    ds = d["ds"]
    base = load_base(osp.join(args.ckpt_dir, "tgnn",
                              f"{args.base_type}_{cfg.data.name}.pt"),
                     device=dev, trainable=True)
    n_degree = int(base.meta.get("n_degree", cfg.model.n_degree))
    predictor = TempME(node_dim=ds.node_feat.shape[1],
                       edge_dim=ds.edge_feat.shape[1], out_dim=ec.out_dim,
                       hid_dim=ec.hid_dim, base_type=args.base_type,
                       dropout=ec.dropout, device=dev, seed=tc.seed)
    print(f"enhance {args.base_type} data={cfg.data.name} predictor params "
          f"{sum(x.numel() for x in predictor.parameters()):,}, base params "
          f"{sum(x.numel() for x in base.model.parameters()):,}, "
          f"n_degree={n_degree} device={dev}")
    # one optimizer over both models; --weight_decay decays the predictor
    # alone, never the trained base
    groups = [{"params": list(predictor.parameters())},
              {"params": list(base.model.parameters()), "weight_decay": 0.0}]
    optimizer = torch.optim.AdamW(groups, lr=tc.lr,
                                  weight_decay=tc.weight_decay) \
        if tc.weight_decay else torch.optim.Adam(groups, lr=tc.lr)
    generator = torch.Generator(device=dev)
    generator.manual_seed(tc.seed)
    is_tgn = base.base_type == "tgn"
    mem = base.memory
    train_step = EnhanceTrainStep(predictor, base, d["g_train"], d["feats"],
                                  d["dst_train"], n_degree, d["node_degree"],
                                  optimizer)
    eval_step = EnhanceEvalStep(predictor, base, d["g_full"], d["feats"],
                                d["dst_test"], n_degree, d["node_degree"])

    ckpt = osp.join(args.ckpt_dir, "enhance", args.base_type,
                    f"{cfg.data.name}.pt")
    train_ckpt = ckpt + ".train_state"
    best_ap, best_auc, best_val = 0.0, 0.0, 0.0
    start_epoch = 0
    if args.resume and osp.exists(train_ckpt):
        blob, tmeta = load_checkpoint(train_ckpt, map_location="cpu")
        predictor.load_state_dict(blob["predictor"])
        base.model.load_state_dict(blob["base"])
        optimizer.load_state_dict(blob["opt_state"])
        generator.set_state(blob["generator"])
        if is_tgn:
            mem = TGNMemoryState(**{k: v.to(dev)
                                    for k, v in blob["memory"].items()})
        start_epoch = tmeta["epoch"] + 1
        best_ap, best_auc, best_val = (tmeta["best_ap"], tmeta["best_auc"],
                                       tmeta["best_val"])
        print(f"resumed from {train_ckpt} at epoch {start_epoch}")
    logger = MetricsLogger(args.log_dir, run_name=time.strftime(
        f"{args.base_type}_{cfg.data.name}_%Y%m%d_%H%M%S_enhance"))
    bs = tc.batch_size
    for epoch in range(start_epoch, tc.n_epoch):
        mem, loss, train_ap, eps, losses = _train_epoch(
            train_step, mem, ds.train, bs, tc.seed + epoch, generator, dev,
            train_base=epoch >= args.freeze_base_epochs)
        # val then test, the memory carried in time order, then set back
        val_ap, val_auc, mem_val = evaluate_enhance(eval_step, mem, ds.val,
                                                    bs)
        test_ap, test_auc, _ = evaluate_enhance(eval_step, mem_val, ds.test,
                                                bs)
        print(f"epoch {epoch}: loss={loss:.4f} train_ap={train_ap:.4f} "
              f"val_ap={val_ap:.4f} test_ap={test_ap:.4f} "
              f"test_auc={test_auc:.4f} ({eps:,.0f} events/s)")
        for i, x in enumerate(losses):
            logger.add_scalar("Train/step_loss", float(x),
                              epoch * len(losses) + i)
        logger.add_scalars("Train", {"loss": loss, "ap": train_ap,
                                     "events_per_s": eps}, epoch)
        logger.add_scalars("Val", {"ap": val_ap, "auc": val_auc}, epoch)
        logger.add_scalars("Test", {"ap": test_ap, "auc": test_auc}, epoch)
        logger.flush()
        if val_ap > best_val:
            best_val, best_ap, best_auc = val_ap, test_ap, test_auc
            save_checkpoint(ckpt, {"predictor": predictor.state_dict(),
                                   "base": base.model.state_dict()},
                            meta=_predictor_meta(args, cfg, ds, n_degree))
            print(f"  saved best enhance checkpoint -> {ckpt} "
                  f"(ap={best_ap:.4f})")
        blob = {"predictor": predictor.state_dict(),
                "base": base.model.state_dict(),
                "opt_state": optimizer.state_dict(),
                "generator": generator.get_state()}
        if is_tgn:
            blob["memory"] = mem._asdict()
        save_checkpoint(train_ckpt, blob,
                        meta=dict(epoch=epoch, best_ap=best_ap,
                                  best_auc=best_auc, best_val=best_val))
    logger.close()
    write_results(args.results_dir,
                  f"enhance_{args.base_type}_{cfg.data.name}",
                  dict(base_type=args.base_type, data=cfg.data.name,
                       ap=best_ap, auc=best_auc, val_ap=best_val))
    return best_ap


def _main_tgat(args, cfg, dev):
    """The TGAT branch: ``TempMETGAT`` on the walks alone, Adam, the best
    checkpoint on test AP, no train state (``--resume`` raises)."""
    if args.resume:
        raise ValueError("the TGAT branch writes no train state to resume "
                         "from (as in the JAX package)")
    ec, tc = cfg.explainer, cfg.train
    d = _data(cfg, dev)
    ds = d["ds"]
    n_degree = cfg.model.n_degree
    tgat_ckpt = osp.join(args.ckpt_dir, "tgnn", f"tgat_{cfg.data.name}.pt")
    if osp.exists(tgat_ckpt + ".json"):
        n_degree = int(load_meta(tgat_ckpt).get("n_degree", n_degree))
    predictor = TempMETGAT(node_dim=ds.node_feat.shape[1],
                           edge_dim=ds.edge_feat.shape[1],
                           out_dim=ec.out_dim, hid_dim=ec.hid_dim,
                           dropout=ec.dropout, device=dev, seed=tc.seed)
    print(f"enhance tgat data={cfg.data.name} predictor params "
          f"{sum(x.numel() for x in predictor.parameters()):,}, "
          f"n_degree={n_degree} device={dev}")
    optimizer = torch.optim.Adam(predictor.parameters(), lr=tc.lr)
    generator = torch.Generator(device=dev)
    generator.manual_seed(tc.seed)
    train_step = EnhanceTrainStep(predictor, None, d["g_train"], d["feats"],
                                  d["dst_train"], n_degree, d["node_degree"],
                                  optimizer)
    eval_step = EnhanceEvalStep(predictor, None, d["g_full"], d["feats"],
                                d["dst_test"], n_degree, d["node_degree"])
    ckpt = osp.join(args.ckpt_dir, "enhance", "tgat", f"{cfg.data.name}.pt")
    best_ap, best_auc = 0.0, 0.0
    logger = MetricsLogger(args.log_dir, run_name=time.strftime(
        f"tgat_{cfg.data.name}_%Y%m%d_%H%M%S_enhance"))
    bs = tc.batch_size
    for epoch in range(tc.n_epoch):
        _, loss, train_ap, eps, losses = _train_epoch(
            train_step, None, ds.train, bs, tc.seed + epoch, generator, dev)
        test_ap, test_auc, _ = evaluate_enhance(eval_step, None, ds.test, bs)
        print(f"epoch {epoch}: loss={loss:.4f} train_ap={train_ap:.4f} "
              f"test_ap={test_ap:.4f} test_auc={test_auc:.4f} "
              f"({eps:,.0f} events/s)")
        for i, x in enumerate(losses):
            logger.add_scalar("Train/step_loss", float(x),
                              epoch * len(losses) + i)
        logger.add_scalars("Train", {"loss": loss, "ap": train_ap,
                                     "events_per_s": eps}, epoch)
        logger.add_scalars("Test", {"ap": test_ap, "auc": test_auc}, epoch)
        logger.flush()
        # chosen on test AP, as the JAX package's TGAT branch does
        if test_ap > best_ap:
            best_ap, best_auc = test_ap, test_auc
            save_checkpoint(ckpt, {"predictor": predictor.state_dict()},
                            meta=_predictor_meta(args, cfg, ds, n_degree))
            print(f"  saved best enhance checkpoint -> {ckpt} "
                  f"(ap={best_ap:.4f})")
    logger.close()
    write_results(args.results_dir, f"enhance_tgat_{cfg.data.name}",
                  dict(base_type="tgat", data=cfg.data.name, ap=best_ap,
                       auc=best_auc))
    return best_ap


if __name__ == "__main__":
    main()
