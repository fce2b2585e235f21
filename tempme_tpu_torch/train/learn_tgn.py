"""TGN link prediction: the train step, the eval step, the split evaluator
and the training driver.

Port of ``tempme_tpu/train/learn_tgn.py`` (``make_tgn_train_step``,
``make_tgn_eval_step``, ``evaluate_tgn``, ``main``). Both steps mask padded
rows, draw negatives and the three 2-hop supports (six ``sample_rows``
launches), advance the memory, run the attention pyramid for src, dst and
negative (six ``attend`` launches: the training form with dropout in the
train step, the eval form in the eval step), score the affinities, persist
the positives, store the last message per node and clear padding row 0.
The train step then takes the masked BCE, runs the backward (six
``attend_bwd`` launches) and an Adam step, and returns the memory detached.

Every TGN variant of the JAX driver trains here (``models/tgn.py``); a
time-embedding TGN takes the train split's time statistics
(``compute_time_statistics``), which its checkpoint meta carries. The
identity and time embeddings read no support, so their steps draw the
negatives (and the unused support uniforms, keeping the draw order) but
sample nothing: no ``sample_rows`` or attention launch.

The JAX package runs a whole epoch as one ``lax.scan`` to cut dispatch
cost; here the step loop is Python (a CUDA graph of the step is later
work).
"""
from __future__ import annotations

import os
import os.path as osp
import time

import numpy as np
import torch

from ..data.events import (RandEdgeSampler, compute_time_statistics,
                           load_dataset)
from ..data.graph import build_temporal_graph
from ..models.common import Features
from ..models.tgn import WHOLE, TGN, TGNMemoryState, init_memory_state
from ..utils import debug
from ..utils import metrics as M
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.devices import resolve_device
from ..utils.logging import MetricsLogger
from . import loops


StepDraws = loops.StepDraws   # dropout: per side (src, tgt, bgd)


def sample_tgn_support(model, g, batch: loops.Batch, dst_table, n: int,
                       draws: loops.SupportDraws, columns=None):
    """The negatives and the three 2-hop supports cut at the batch time
    (as the JAX step's ``use_eidx=False``); a TGN that reads no support
    gets the negatives and None for each support. ``columns`` as in
    ``find_k_hop``."""
    if model.reads_support:
        return loops.sample_support(g, batch, dst_table, model.n_layers, n,
                                    draws, use_eidx=False, columns=columns)
    return (dst_table[draws.neg_idx],) + (None,) * 3


class TGNTrainStep:
    """``step(mem, batch, draws) -> (new_mem, {"loss", "pos", "neg"})``: one
    Adam step of ``optimizer`` over ``model``'s parameters. The gradients
    stay in the parameters' ``.grad`` until the next step."""

    def __init__(self, model, g_train, feats, dst_table: torch.Tensor, n: int,
                 optimizer: torch.optim.Optimizer):
        self.model, self.g, self.feats = model, g_train, feats
        self.dst_table, self.n, self.optimizer = dst_table, n, optimizer

    def draw(self, generator: torch.Generator, batch_size: int) -> StepDraws:
        """The step's draws from ``generator``, in a fixed order: the
        support (negatives, then per side the hops), then, when the model
        has dropout, per side and per layer the probabilities' and fc's
        uniforms."""
        dev = self.g.device
        support = loops.draw_support(generator, batch_size,
                                     self.model.n_layers, self.n,
                                     self.dst_table.shape[0], dev)
        dropout = None
        if self.model.dropout > 0.0:
            shapes = self.model.dropout_shapes(batch_size, self.n)
            dropout = tuple(loops.draw_dropout(generator, shapes, dev)
                            for _ in range(3))
        return StepDraws(support, dropout)

    def contrast(self, mem, batch: loops.Batch, draws: StepDraws,
                 exchange=None, shard=WHOLE):
        """The step's forward: padded rows masked, the support sampled
        from ``draws``, the training-form contrast. Returns ((pos, neg),
        new_mem); ``exchange`` and ``shard`` as in ``TGN.get_node_emb``
        (the deeper hops sampled on ``shard``'s columns)."""
        batch = loops.mask_batch_nodes(batch)
        bgd, s_src, s_tgt, s_bgd = sample_tgn_support(
            self.model, self.g, batch, self.dst_table, self.n, draws.support,
            columns=None if shard is WHOLE else shard.columns)
        return self.model.contrast(
            self.feats, mem, batch.src, batch.dst, bgd, batch.ts, batch.eidx,
            s_src, s_tgt, s_bgd, drop=draws.dropout, exchange=exchange,
            shard=shard)

    @staticmethod
    def loss(pos, neg, mask, count=None):
        """The masked BCE of the positive and negative logits (``count`` as
        in ``loops.masked_bce_with_logits``)."""
        ones = torch.ones(pos.shape[0], device=pos.device)
        return (loops.masked_bce_with_logits(pos, ones, mask, count)
                + loops.masked_bce_with_logits(neg, ones * 0, mask, count))

    @staticmethod
    def finish(new_mem, loss, pos, neg, keep=()):
        """The step's results: the memory detached (the next step must not
        reach back into this step's graph) with padding row 0 cleared
        (``keep`` as in ``loops.scrub_padding_row``), and the aux dict."""
        new_mem = loops.scrub_padding_row(
            type(new_mem)(*(x.detach() for x in new_mem)), keep)
        return new_mem, {"loss": loss.detach(),
                         "pos": pos.detach().squeeze(-1),
                         "neg": neg.detach().squeeze(-1)}

    def __call__(self, mem, batch: loops.Batch, draws: StepDraws):
        self.optimizer.zero_grad(set_to_none=True)
        (pos, neg), new_mem = self.contrast(mem, batch, draws)
        loss = self.loss(pos, neg, batch.mask)
        loss.backward()
        self.optimizer.step()
        return self.finish(new_mem, loss, pos, neg)


def make_tgn_train_step(model, g_train, feats, dst_table, n,
                        optimizer) -> TGNTrainStep:
    return TGNTrainStep(model, g_train, feats, dst_table, n, optimizer)


class TGNEvalStep:
    """``step(mem, batch, draws) -> (pos [B], neg [B], new_mem)``."""

    def __init__(self, model, g_full, feats, dst_table: torch.Tensor, n: int):
        self.model, self.g, self.feats = model, g_full, feats
        self.dst_table, self.n = dst_table, n

    def draw(self, generator: torch.Generator, batch_size: int):
        return loops.draw_support(generator, batch_size, self.model.n_layers,
                                  self.n, self.dst_table.shape[0],
                                  self.g.device)

    @torch.no_grad()
    def __call__(self, mem, batch: loops.Batch, draws: loops.SupportDraws):
        batch = loops.mask_batch_nodes(batch)
        bgd, s_src, s_tgt, s_bgd = sample_tgn_support(
            self.model, self.g, batch, self.dst_table, self.n, draws)
        (pos, neg), new_mem = self.model.contrast(
            self.feats, mem, batch.src, batch.dst, bgd, batch.ts, batch.eidx,
            s_src, s_tgt, s_bgd)
        return (pos.squeeze(-1), neg.squeeze(-1),
                loops.scrub_padding_row(new_mem))


def make_tgn_eval_step(model, g_full, feats, dst_table, n) -> TGNEvalStep:
    return TGNEvalStep(model, g_full, feats, dst_table, n)


def evaluate_tgn(eval_step: TGNEvalStep, mem, events, batch_size: int,
                 seed: int = 0, draws=None):
    """Score a split in time order, carrying the memory through it (the
    caller's ``mem`` is not modified). ``draws`` is an optional iterable of
    ``SupportDraws``, one per batch; by default they come from a
    ``torch.Generator`` seeded with ``seed`` on the graph's device. Returns
    ``({"ap", "auc", "acc"}, new memory)``."""
    dev = eval_step.g.device
    if draws is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        draws = iter(lambda: eval_step.draw(gen, batch_size), None)
    draws = iter(draws)
    scores, masks = [], []
    for batch in loops.iter_batches(events, batch_size,
                                    drop_remainder=False, device=dev):
        pos, neg, mem = eval_step(mem, batch, next(draws))
        scores.append(torch.stack([torch.sigmoid(pos), torch.sigmoid(neg)]))
        masks.append(batch.mask)
    s = torch.stack(scores).cpu().numpy()          # [K, 2, B]
    m = torch.stack(masks).cpu().numpy()           # [K, B]
    labels = np.broadcast_to(np.array([1.0, 0.0])[None, :, None], s.shape)
    m2 = np.broadcast_to(m[:, None, :], s.shape)
    out = dict(ap=M.average_precision_score(labels, s, m2),
               auc=M.roc_auc_score(labels, s, m2),
               acc=M.accuracy_score(labels, s, mask=m2))
    return out, mem


def _train_blob(state: loops.TrainState, mem) -> dict:
    return dict(state.state_dict(), memory=mem._asdict())


def main(args, cfg, device=None):
    """The TGN training driver; ``learn_base.main`` parses the flags into
    ``args`` and ``cfg``. Shuffled full batches per epoch, val then test
    with the memory carried and restored, the best checkpoint by val AP, a
    per-epoch train-state checkpoint (and one every ``--ckpt_every_steps``
    steps), ``--resume``, early stopping and the results JSON. Runs on the
    CUDA device unless ``device="cpu"``. Returns the best checkpoint's test
    AP."""
    dev = resolve_device(device)
    mc, bs = cfg.model, cfg.train.batch_size
    ds = load_dataset(cfg.data.name, cfg.data.data_dir)
    g_train = build_temporal_graph(ds.train, ds.full.num_nodes,
                                   ds.full.num_edges, device=dev)
    g_full = build_temporal_graph(ds.full, ds.full.num_nodes,
                                  ds.full.num_edges, device=dev)
    feats = Features(torch.from_numpy(ds.node_feat).to(dev),
                     torch.from_numpy(ds.edge_feat).to(dev))
    mean_shift, std_shift = (0.0, 0.0), (1.0, 1.0)
    if mc.embedding_module == "time":
        mean_shift, std_shift = compute_time_statistics(ds.train)
    model = TGN(node_dim=ds.node_feat.shape[1],
                edge_dim=ds.edge_feat.shape[1], num_nodes=ds.full.num_nodes,
                n_layers=2, n_head=mc.n_heads, dropout=mc.dropout,
                message_dim=mc.message_dim,
                memory_updater=mc.memory_updater, aggregator=mc.aggregator,
                message_function=mc.message_function,
                embedding_type=mc.embedding_module,
                mean_time_shift=mean_shift, std_time_shift=std_shift,
                device=dev, seed=cfg.train.seed)
    mem = init_memory_state(ds.full.num_nodes, model.memory_dim,
                            model.raw_message_dim, device=dev)
    train_sampler = RandEdgeSampler([ds.train.src], [ds.train.dst])
    test_sampler = RandEdgeSampler([ds.train.src, ds.val.src, ds.test.src],
                                   [ds.train.dst, ds.val.dst, ds.test.dst])
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model=tgn data={cfg.data.name} params={n_params:,} "
          f"n_degree={mc.n_degree} device={dev}")

    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.train.lr)
    generator = torch.Generator(device=dev)
    generator.manual_seed(cfg.train.seed)
    state = loops.TrainState(model, optimizer, generator)
    train_step = make_tgn_train_step(
        model, g_train, feats,
        torch.from_numpy(train_sampler.dst_list).to(dev), mc.n_degree,
        optimizer)
    eval_step = make_tgn_eval_step(
        model, g_full, feats, torch.from_numpy(test_sampler.dst_list).to(dev),
        mc.n_degree)

    stopper = M.EarlyStopMonitor(max_round=args.patience)
    best = None
    os.makedirs(args.out_dir, exist_ok=True)
    ckpt_path = osp.join(args.out_dir, f"tgn_{cfg.data.name}.pt")
    # stop/resume train-state checkpoint: params, Adam state, generator and
    # memory (the TGN memory is part of the sequential training state)
    train_ckpt = ckpt_path + ".train_state"
    start_epoch, start_step = 0, 0
    if getattr(args, "resume", False) and osp.exists(train_ckpt):
        blob, tmeta = load_checkpoint(train_ckpt, map_location="cpu")
        state.load_state_dict(blob)
        mem = TGNMemoryState(**{k: v.to(dev)
                                for k, v in blob["memory"].items()})
        best = tmeta["best"]
        stopper.load_state_dict(tmeta["stopper"])
        if tmeta.get("step", -1) >= 0:   # mid-epoch (--ckpt_every_steps)
            start_epoch, start_step = tmeta["epoch"], tmeta["step"]
            print(f"resumed from {train_ckpt} at epoch {start_epoch} "
                  f"step {start_step}")
        else:
            start_epoch = tmeta["epoch"] + 1
            print(f"resumed from {train_ckpt} at epoch {start_epoch}")
    logger = MetricsLogger(
        args.log_dir,
        run_name=time.strftime(f"tgn_{cfg.data.name}_%Y%m%d_%H%M%S"))
    if debug.enabled():
        debug.install()
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
            mem, aux = train_step(mem, batch, train_step.draw(generator, bs))
            auxs.append(aux)
            if args.ckpt_every_steps and \
                    (i + 1) % args.ckpt_every_steps == 0 and \
                    i + 1 < n_batches:
                save_checkpoint(train_ckpt, _train_blob(state, mem),
                                meta=dict(epoch=epoch, step=i + 1, best=best,
                                          stopper=stopper.state_dict()))
        losses, pos, neg = (torch.stack([a[key] for a in auxs]).cpu().numpy()
                            for key in ("loss", "pos", "neg"))
        pos, neg = 1 / (1 + np.exp(-pos)), 1 / (1 + np.exp(-neg))
        dt = time.time() - t0
        if debug.enabled():
            debug.check_finite(dict(model.named_parameters()),
                               "params after epoch")
            debug.check_finite(mem, "tgn memory after epoch")
        # after a mid-epoch resume only the remaining steps ran this process
        k = losses.shape[0]
        n_events = k * bs
        labels = np.r_[np.ones(bs), np.zeros(bs)]
        aps = [M.average_precision_score(labels, np.r_[pos[i], neg[i]])
               for i in range(k)]
        mem_backup = mem                       # backup_memory
        # selection and early stop on val (test is reported only); the
        # memory advances train -> val -> test in time order, then restores
        val, mem_val = evaluate_tgn(eval_step, mem, ds.val, bs)
        test, _ = evaluate_tgn(eval_step, mem_val, ds.test, bs)
        mem = mem_backup                       # restore_memory
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
            # the checkpoint carries the train-side memory state
            save_checkpoint(
                ckpt_path, {"params": model.state_dict(),
                            "memory": mem_backup._asdict()},
                meta=dict(base_type="tgn", data=cfg.data.name,
                          n_degree=mc.n_degree, n_layer=2, n_head=mc.n_heads,
                          drop_out=mc.dropout,
                          node_dim=ds.node_feat.shape[1],
                          edge_dim=ds.edge_feat.shape[1],
                          num_nodes=ds.full.num_nodes,
                          memory_updater=mc.memory_updater,
                          aggregator=mc.aggregator,
                          message_function=mc.message_function,
                          embedding_module=mc.embedding_module,
                          mean_time_shift=list(mean_shift),
                          std_time_shift=list(std_shift)))
            print(f"  saved best checkpoint -> {ckpt_path} "
                  f"(ap={best['ap']:.4f})")
        stop = stopper.early_stop_check(val["ap"])
        save_checkpoint(train_ckpt, _train_blob(state, mem),
                        meta=dict(epoch=epoch, best=best,
                                  stopper=stopper.state_dict()))
        if stop:
            print(f"early stop at epoch {epoch}")
            break
    logger.close()
    if best is not None:
        from .learn_base import write_results
        write_results(args.results_dir, f"base_tgn_{cfg.data.name}",
                      dict(base_type="tgn", data=cfg.data.name, **best))
    return 0.0 if best is None else best["ap"]
