"""TempME explainer training and evaluation on a frozen TGN, TGAT or
GraphMixer.

Usage:
    python -m tempme_tpu_torch.train.temp_exp_main --data wikipedia \
        --data_dir processed --base_type tgn --n_epoch 10 --bs 100

Port of ``tempme_tpu/train/temp_exp_main.py``. Per train step: the
negatives, the three supports (``sample_rows``; as many hops as a TGAT has
layers, 2 for a TGN or a GraphMixer) and the three sides' motif walks
(``sample_union``, ``sample_masked``) are sampled on the card; the frozen
base labels the batch; the explainer (``TempME``, or ``TempMETGAT``, which
also reads the anchor pair) scores the walks, carries the scores onto the
support edges of the hops the base reads (hops 0 and 1; a GraphMixer's hop
0) (``walk_to_edge``) and samples them by the Beta reparameterisation; the
base runs again with those weights (on a TGN's or a TGAT's attention
probabilities, a 3-layer TGAT's hop 2 unweighted; at a GraphMixer's mixer
blocks, tokens and node scores), and Adam (or AdamW) steps the explainer
on BCE(pred, y_ori) + beta * KL(motif prior), the gradient reaching the
weights through the base's backward (``attend_bwd`` for a TGN or a TGAT)
and ``walk_to_edge``'s backward. The eval step adds fidelity (prob and
logit) and the 16-ratio sweep through the base's ``ratio_contrast`` (a
3-layer TGAT's in chunks of 4 ratios, which bounds its [R * B, n**2, D]
levels; a GraphMixer's top-k over its n hop-0 edges alone).

The driver reads the base checkpoint that ``learn_base`` wrote
(``{ckpt_dir}/tgnn/{base_type}_{data}.pt``), keeps the best explainer on val
Ratio-APS (a resumed run must strictly beat the restored best), writes a
train-state checkpoint each epoch (and every ``--ckpt_every_steps``
steps), resumes from it (``--resume``), and evaluates a saved explainer
alone (``--eval_only``). It runs on the CUDA device unless a Python caller
passes ``device="cpu"`` to ``main``.

With ``--use_cache`` the driver trains from the offline walk cache
(``data/cache.py``): ``{cache_dir}/{data}_{train,test}.npz``, built at the
base's ``n_degree`` when absent (the negatives seeded from ``--seed``),
read otherwise. A train step then takes its negatives, supports and walks
from the cache, sliced on the host in ``stack_batches``' shuffle order,
and draws only the dropout, gate and gamma draws; test is evaluated from
the test cache, val online, as in the JAX package. The cache holds 2-hop
supports, so a 3-layer TGAT refuses it. ``--profile`` traces the training
steps of epoch index 1 (epoch 0 pays the warm-up) with ``torch.profiler``
into ``{log_dir}/trace`` (a Chrome trace, which ``tools/op_census.py``
reads) and prints its path; a run that does not train epoch 1 (``--n_epoch
1``) traces nothing and says so.

The explanation weights each support edge's attention probability and
the sweep masks the support's edges, so the driver refuses, right after
loading it, a base it cannot explain (``explainable``): a TGAT with the
LSTM or mean pool (no explain weights) or map attention (no map form of
the ratio sweep), a TGN with the identity or time embedding. The JAX
driver fails on these too, by assertion.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import os.path as osp
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import (DEFAULT_RATIOS, add_common_args, add_explainer_args,
                      config_from_args)
from ..data import cache as C
from ..data.events import RandEdgeSampler, load_dataset
from ..data.graph import build_temporal_graph
from ..explain.null_model import get_null_distribution
from ..explain.tempme import (EdgeDraws, ImpDraws, TempME, kl_sparsity_loss,
                              make_walk_inputs)
from ..explain.tempme_tgat import TempMETGAT, TGATImpDraws
from ..models.common import Features
from ..ops import sampler as S
from ..utils import metrics as M
from ..utils import profiling
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.devices import resolve_device
from ..utils.logging import MetricsLogger
from . import loops
from .base_loader import LoadedBase, load_base
from .learn_base import write_results

N_WALK_CONT = 3          # continuations per first walk event
PROFILE_EPOCH = 1        # --profile traces this epoch's training
DEEP_SWEEP_CHUNK = 4     # ratios per ratio_contrast of a 3-hop TGAT


class ExplainerDraws(NamedTuple):
    """Every random number one explainer step consumes. ``imp`` and
    ``edge`` (per side) are the explainer's dropout uniforms (a TGAT's
    explainer has no ``edge``), None in eval. ``gamma`` is per side the
    Beta sample's draws (ga0, gb0, ga1, gb1), or a ``torch.Generator`` to
    take them from, or None in eval."""
    support: loops.SupportDraws
    walks: tuple                       # per side S.WalkDraws
    imp: Optional[tuple] = None        # per side ImpDraws or TGATImpDraws
    edge: Optional[tuple] = None       # per side EdgeDraws
    gamma: object = None


def explainable(base: LoadedBase) -> None:
    """Raise ``ValueError`` naming the reason where the explainer cannot
    explain ``base``: its explanation weights scale attention
    probabilities over the support's edges and its ratio sweep runs the
    base's split-attention form."""
    m = base.model
    if base.base_type == "tgat" and not m.uses_split_attention:
        if m.agg_method == "attn":
            why = ("map attention takes the explain weights, but the "
                   "explainer's ratio sweep has no map form (the TGAT's "
                   "ratio_contrast runs split attention only)")
        else:
            why = (f"the {m.agg_method} pool takes no explain weights (it "
                   f"has no attention probabilities over the support's "
                   f"edges to weight)")
        raise ValueError(
            f"the explainer needs a TGAT with --agg_method attn and "
            f"--attn_mode prod; this one has agg_method {m.agg_method}, "
            f"attn_mode {m.attn_mode}: {why}")
    if base.base_type == "tgn" and not m.reads_support:
        raise ValueError(
            f"the explainer needs a TGN with --embedding_module "
            f"graph_attention: a TGN with the {m.embedding_type} embedding "
            f"reads no support edges, so there is nothing to explain")


def make_base_contrast(base: LoadedBase):
    """``contrast(feats, src, tgt, bgd, ts, eidx, subs, explain) -> (pos,
    neg)`` logits [B, 1] of the frozen base, a TGN's memory left as it
    was; ``explain`` is None or per hop the stacked [3B, width] weights of
    the three sides (src, tgt, bgd). A TGAT takes them as its pair of
    pairs, hops deeper than the explanation's unweighted; a GraphMixer its
    one hop split over the three sides."""
    if base.base_type == "graphmixer":
        def contrast_mixer(feats, src, tgt, bgd, ts, eidx, subs, explain):
            ew = None if explain is None else explain[0].chunk(3, dim=0)
            return base.model.contrast(feats, src, tgt, bgd, ts, *subs,
                                       explain_weights=ew)
        return contrast_mixer
    if base.base_type == "tgat":
        def contrast_tgat(feats, src, tgt, bgd, ts, eidx, subs, explain):
            ew = None
            if explain is not None:
                hops = [h.chunk(3, dim=0) for h in explain]
                pad = [None] * (len(subs[0].nodes) - len(hops))
                imp_src, imp_tgt, imp_bgd = ([hop[i] for hop in hops] + pad
                                             for i in range(3))
                ew = ((imp_src, imp_tgt), (imp_src, imp_bgd))
            return base.model.contrast(feats, src, tgt, bgd, ts, *subs,
                                       explain_weights=ew)
        return contrast_tgat
    if base.base_type != "tgn":
        raise ValueError(f"unknown base_type {base.base_type}")

    def contrast(feats, src, tgt, bgd, ts, eidx, subs, explain):
        ew = None
        if explain is not None:
            hops = [h.chunk(3, dim=0) for h in explain]
            ew = tuple([hop[i] for hop in hops] for i in range(3))
        (pos, neg), _ = base.model.contrast(
            feats, base.memory, src, tgt, bgd, ts, eidx, *subs,
            explain_weights=ew, update_memory=False)
        return pos, neg
    return contrast


def sample_explainer_inputs(g, batch: loops.Batch, dst_table, n_degree: int,
                            draws: ExplainerDraws, k_hops: int = 2):
    """Negatives, the three ``k_hops``-hop supports (cut at the batch's
    edges for src and tgt; as deep as the base) and the three sides' walks
    (from hop 0), on the graph's device."""
    bgd, *subs = loops.sample_support(g, batch, dst_table, k_hops, n_degree,
                                      draws.support, use_eidx=True)
    walks = tuple(make_walk_inputs(S.find_k_walks(
        g, wd, anchor, sub, n_degree, N_WALK_CONT))
        for wd, anchor, sub in zip(draws.walks, (batch.src, batch.dst, bgd),
                                   subs))
    return bgd, tuple(subs), walks


def ratio_topk_keep(imp, ratios, num_edge: int):
    """[B, num_edge] importance -> [R, B, num_edge] keep masks: per ratio
    the ceil(r * num_edge) most important edges, exact ties broken by the
    lower index (a double stable argsort)."""
    topks = torch.tensor([min(max(int(np.ceil(r * num_edge)), 1), num_edge)
                          for r in ratios], device=imp.device)
    order = torch.argsort(-imp, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    return rank[None] < topks[:, None, None]


def keep_masks_for_ratios(explanation, ratios, n_degree: int,
                          use_hops: int = 2):
    """Per side the per-hop [R, B, width] keep masks of the ratio sweep, the
    top-k taken over the first ``use_hops`` hops' edges together (2 for a
    TGN or a TGAT, 1 for a GraphMixer: its n hop-0 edges)."""
    widths = (n_degree, n_degree * n_degree)[:use_hops]

    def side(i):
        imp = torch.cat([h.chunk(3, dim=0)[i]
                         for h in explanation[:use_hops]], dim=1)
        keep = ratio_topk_keep(imp, ratios, sum(widths))
        return list(keep.split(widths, dim=-1))
    return [side(i) for i in range(3)]


class _Steps:
    """What the train and eval steps share: the explainer, the frozen base,
    the graph, the features, the negatives' table and the prior. The
    supports are as deep as the base (a TGAT's layers; 2 hops for a TGN or
    a GraphMixer)."""

    def __init__(self, explainer, base: LoadedBase, g, feats, dst_table,
                 n_degree: int, null_dist, prior_p: float):
        self.explainer, self.base, self.g = explainer, base, g
        self.feats, self.dst_table, self.n = feats, dst_table, n_degree
        self.null_dist, self.prior_p = null_dist, prior_p
        self.contrast = make_base_contrast(base)
        self.is_tgat = base.base_type == "tgat"
        self.k_hops = base.model.num_layers if self.is_tgat else 2

    def _support_and_walks(self, generator, batch_size):
        dev = self.g.device
        support = loops.draw_support(generator, batch_size, self.k_hops,
                                     self.n, self.dst_table.shape[0], dev)
        walks = tuple(S.draw_walks(generator, batch_size, self.n,
                                   N_WALK_CONT, dev) for _ in range(3))
        return support, walks

    def _forward(self, batch, draws: ExplainerDraws, training: bool,
                 inputs=None):
        """``inputs``: the batch's ``(bgd, subs, walks)`` from the walk
        cache (``cache_to_inputs``), or None to sample them from
        ``draws``."""
        bgd, subs, walks = inputs if inputs is not None else \
            sample_explainer_inputs(self.g, batch, self.dst_table, self.n,
                                    draws, self.k_hops)
        args = (batch.src, batch.dst, bgd, batch.ts, batch.eidx, subs)
        with torch.no_grad():
            pos_ori, neg_ori = self.contrast(self.feats, *args, None)
        imp = draws.imp or (None,) * 3
        if self.is_tgat:     # each side's walks read with its anchor pair
            imps = [self.explainer(self.feats, walks[i], a, batch.ts, o,
                                   imp[i])
                    for i, (a, o) in enumerate(((batch.src, batch.dst),
                                                (batch.dst, batch.src),
                                                (bgd, batch.src)))]
            explanation = self.explainer.retrieve_explanation(
                self.feats, subs, imps, walks, training, draws.gamma)
        else:
            imps = [self.explainer(self.feats, walks[i], batch.ts, imp[i])
                    for i in range(3)]
            explanation = self.explainer.retrieve_explanation(
                self.feats, subs, imps, walks, training, draws.edge,
                draws.gamma)
        pos, neg = self.contrast(self.feats, *args, explanation)
        kl = sum(kl_sparsity_loss(imps[i], walks[i].cat, self.null_dist,
                                  self.prior_p) for i in range(3))
        return dict(bgd=bgd, subs=subs, explanation=explanation,
                    pos_ori=pos_ori, neg_ori=neg_ori, pos=pos, neg=neg, kl=kl)


class ExplainerTrainStep(_Steps):
    """``step(batch, draws) -> aux``: one optimizer step of the explainer;
    the gradients stay in its parameters' ``.grad`` until the next step."""

    def __init__(self, explainer, base, g_train, feats, dst_table, n_degree,
                 null_dist, optimizer, prior_p=0.3, beta=0.5, if_bern=True):
        super().__init__(explainer, base, g_train, feats, dst_table, n_degree,
                         null_dist, prior_p)
        self.optimizer, self.beta, self.if_bern = optimizer, beta, if_bern

    def draw(self, generator: torch.Generator, batch_size: int,
             sample: bool = True) -> ExplainerDraws:
        """The step's draws from ``generator`` in a fixed order: support,
        walks (unless ``sample`` is False: the inputs come from the walk
        cache), then per side the importance's dropout uniforms, then per
        side the gate's (a TGN's explainer); the gamma draws come from the
        same generator inside the step."""
        support, walks = self._support_and_walks(generator, batch_size) \
            if sample else (None, None)
        imp = edge = None
        if self.explainer.dropout > 0.0:
            dev = self.g.device

            def rand(shapes, cls):
                return cls(*(torch.rand(s, generator=generator, device=dev)
                             for s in shapes))
            shapes = self.explainer.draw_shapes(batch_size,
                                                self.n * N_WALK_CONT)
            if self.is_tgat:
                imp = tuple(rand(shapes, TGATImpDraws) for _ in range(3))
            else:
                imp = tuple(rand(shapes[0], ImpDraws) for _ in range(3))
                edge = tuple(rand(shapes[1], EdgeDraws) for _ in range(3))
        return ExplainerDraws(support, walks, imp, edge,
                              generator if self.if_bern else None)

    def __call__(self, batch: loops.Batch, draws: ExplainerDraws,
                 inputs=None):
        self.optimizer.zero_grad(set_to_none=True)
        out = self._forward(batch, draws, self.if_bern, inputs)
        pos, neg, pos_ori, neg_ori = (out[k] for k in ("pos", "neg",
                                                       "pos_ori", "neg_ori"))
        y_ori = (torch.cat([pos_ori, neg_ori]) > 0.0).float()
        pred = torch.cat([pos, neg])
        pred_loss = torch.nn.functional.binary_cross_entropy_with_logits(
            pred, y_ori)
        loss = pred_loss + self.beta * out["kl"]
        loss.backward()
        self.optimizer.step()
        with torch.no_grad():
            fid_prob = torch.cat([torch.sigmoid(pos) - torch.sigmoid(pos_ori),
                                  torch.sigmoid(neg_ori) - torch.sigmoid(neg)]
                                 ).mean()
            fid_logit = torch.cat([pos - pos_ori, neg_ori - neg]).mean()
        return dict(loss=loss.detach(), pred_loss=pred_loss.detach(),
                    kl=out["kl"].detach(), y_ori=y_ori.squeeze(-1),
                    y_pred=torch.sigmoid(pred.detach()).squeeze(-1),
                    fid_prob=fid_prob, fid_logit=fid_logit)


class ExplainerEvalStep(_Steps):
    """``step(batch, draws) -> out``: the labels, the explained logits,
    the fidelity inputs and the ratio sweep's logits [R, B]."""

    def __init__(self, explainer, base, g_full, feats, dst_table, n_degree,
                 null_dist, prior_p=0.3, ratios=DEFAULT_RATIOS):
        super().__init__(explainer, base, g_full, feats, dst_table, n_degree,
                         null_dist, prior_p)
        self.ratios = ratios

    def draw(self, generator: torch.Generator,
             batch_size: int) -> ExplainerDraws:
        return ExplainerDraws(*self._support_and_walks(generator, batch_size))

    @torch.no_grad()
    def __call__(self, batch: loops.Batch, draws: ExplainerDraws,
                 inputs=None):
        out = self._forward(batch, draws, False, inputs)
        keeps = keep_masks_for_ratios(out["explanation"], self.ratios,
                                      self.n, len(out["explanation"]))
        args = (batch.src, batch.dst, out["bgd"], batch.ts, *out["subs"])
        if self.base.base_type == "graphmixer":      # hop 0's masks alone
            pos_r, neg_r = self.base.model.ratio_contrast(
                self.feats, *args, *(k[0] for k in keeps))
        elif self.is_tgat:
            # a 3-hop pyramid sweeps 4 ratios at a time (the JAX package's
            # lax.map over chunks), a 2-hop one all at once
            pos_r, neg_r = self.base.model.ratio_contrast(
                self.feats, *args, *keeps,
                chunk=DEEP_SWEEP_CHUNK if self.k_hops > 2 else None)
        else:
            pos_r, neg_r = self.base.model.ratio_contrast(
                self.feats, self.base.memory, *args, *keeps)
        pred = torch.cat([out["pos"], out["neg"]])
        return dict(y_ori=(torch.cat([out["pos_ori"], out["neg_ori"]]) > 0.0)
                    .float().squeeze(-1), pred=pred.squeeze(-1),
                    pos_ori=out["pos_ori"].squeeze(-1),
                    neg_ori=out["neg_ori"].squeeze(-1),
                    pos=out["pos"].squeeze(-1), neg=out["neg"].squeeze(-1),
                    kl=out["kl"], pos_r=pos_r, neg_r=neg_r)


def _sig(x):
    return 1.0 / (1.0 + np.exp(-x))


def run_eval(eval_step: ExplainerEvalStep, events, batch_size: int,
             test_threshold: bool = True, seed: int = 1234,
             cache: Optional[dict] = None) -> dict:
    """The eval protocol over a split in time order: per batch AP, AUC and
    accuracy of the explained prediction against the base's own labels,
    fidelity (prob and logit) and, with ``test_threshold``, the ratio
    sweep's mean APS, AUC, ACC, prob and logit; then the means over the
    batches. Padded rows of the last batch are left out. With ``cache``
    (the split's walk cache) each batch's inputs are its rows there (the
    padding rows read row 0, as the padding events are event 0)."""
    dev = eval_step.g.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    outs, masks = [], []
    for i, batch in enumerate(loops.iter_batches(
            events, batch_size, drop_remainder=False, device=dev)):
        if cache is None:
            outs.append(eval_step(batch, eval_step.draw(gen, batch_size)))
        else:
            idx = np.arange(i * batch_size, (i + 1) * batch_size)
            idx[idx >= len(events)] = 0
            outs.append(eval_step(batch, ExplainerDraws(None, None),
                                  C.cache_to_inputs(cache, idx, eval_step.n,
                                                    dev)))
        masks.append(batch.mask)
    stats = {k: [] for k in ("aps", "auc", "acc", "fid_prob", "fid_logit",
                             "r_aps", "r_auc", "r_acc", "r_prob", "r_logit")}
    for out, m in zip(outs, masks):
        out = {k: v.cpu().numpy() for k, v in out.items()}
        m = m.cpu().numpy()
        m2 = np.r_[m, m]
        y_ori = out["y_ori"][m2]
        y_pred = _sig(out["pred"])[m2]
        stats["aps"].append(M.average_precision_score(y_ori, y_pred))
        stats["auc"].append(M.roc_auc_score(y_ori, y_pred))
        stats["acc"].append(M.accuracy_score(y_ori, y_pred))
        pos_ori, neg_ori = out["pos_ori"][m], out["neg_ori"][m]
        pos, neg = out["pos"][m], out["neg"][m]
        stats["fid_prob"].append(np.r_[_sig(pos) - _sig(pos_ori),
                                       _sig(neg_ori) - _sig(neg)].mean())
        stats["fid_logit"].append(np.r_[pos - pos_ori, neg_ori - neg].mean())
        if test_threshold:
            pos_r, neg_r = out["pos_r"][:, m], out["neg_r"][:, m]
            per = {k: [] for k in ("r_aps", "r_auc", "r_acc", "r_prob",
                                   "r_logit")}
            for ri in range(pos_r.shape[0]):
                yp = _sig(np.r_[pos_r[ri], neg_r[ri]])
                per["r_aps"].append(M.average_precision_score(y_ori, yp))
                per["r_auc"].append(M.roc_auc_score(y_ori, yp))
                per["r_acc"].append(M.accuracy_score(y_ori, yp))
                per["r_prob"].append(np.r_[_sig(pos_r[ri]) - _sig(pos_ori),
                                           _sig(neg_ori) - _sig(neg_r[ri])]
                                     .mean())
                per["r_logit"].append(np.r_[pos_r[ri] - pos_ori,
                                            neg_ori - neg_r[ri]].mean())
            for k, v in per.items():
                stats[k].append(np.mean(v))
    return {k: float(np.mean(v)) if v else 0.0 for k, v in stats.items()}


def open_caches(cache_dir: str, data: str, n_degree: int, splits: dict,
                samplers: dict, seed: int) -> dict:
    """``{mode: cache}`` for each ``mode`` of ``splits`` (``{mode: (events,
    graph)}``): read from ``{cache_dir}/{data}_{mode}.npz``, built with
    ``samplers[mode]``'s negatives and written there first when absent."""
    os.makedirs(cache_dir, exist_ok=True)
    caches = {}
    for mode, (events, g) in splits.items():
        path = osp.join(cache_dir, f"{data}_{mode}.npz")
        if not osp.exists(path):
            print(f"building walk cache -> {path}")
            C.save_cache(path, C.build_walk_cache(g, events, samplers[mode],
                                                  n_degree, seed=seed))
        caches[mode] = C.load_cache(path)
    return caches


def _print_eval(ev: dict, epoch: int, split: str) -> None:
    print(f"[eval {split} epoch {epoch}] aps={ev['aps']:.4f} "
          f"auc={ev['auc']:.4f} acc={ev['acc']:.4f} "
          f"fid_prob={ev['fid_prob']:.4f} fid_logit={ev['fid_logit']:.4f} | "
          f"ratio: APS={ev['r_aps']:.4f} AUC={ev['r_auc']:.4f} "
          f"ACC={ev['r_acc']:.4f} prob={ev['r_prob']:.4f} "
          f"logit={ev['r_logit']:.4f}")


def main(argv=None, device=None):
    """The explainer driver. Returns the best val score, or the eval's
    metrics with ``--eval_only``."""
    p = argparse.ArgumentParser("tempme_tpu_torch explainer training")
    add_common_args(p, bs=100, n_epoch=10, lr=1e-3)
    add_explainer_args(p)
    p.add_argument("--base_type", type=str, default="tgn")
    p.add_argument("--test_bs", type=int, default=100)
    p.add_argument("--if_bern", type=int, default=1)
    p.add_argument("--test_threshold", type=int, default=1)
    p.add_argument("--ckpt_dir", type=str, default="params_torch")
    p.add_argument("--eval_only", action="store_true",
                   help="load the saved explainer and run the eval protocol "
                        "once (no training)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the .train_state checkpoint")
    p.add_argument("--profile", action="store_true",
                   help="trace the training of epoch index 1 with "
                        "torch.profiler into {log_dir}/trace")
    p.add_argument("--use_cache", action="store_true",
                   help="train and evaluate test from the offline walk cache "
                        "(built on first use) instead of sampling online")
    p.add_argument("--cache_dir", type=str, default="cache_torch")
    args = p.parse_args(argv)
    cfg = config_from_args(args)
    ec, tc = cfg.explainer, cfg.train
    dev = resolve_device(device)

    ds = load_dataset(cfg.data.name, cfg.data.data_dir)
    nn_, ne = ds.full.num_nodes, ds.full.num_edges
    g_train = build_temporal_graph(ds.train, nn_, ne, device=dev)
    g_full = build_temporal_graph(ds.full, nn_, ne, device=dev)
    feats = Features(torch.from_numpy(ds.node_feat).to(dev),
                     torch.from_numpy(ds.edge_feat).to(dev))
    base = load_base(osp.join(args.ckpt_dir, "tgnn",
                              f"{args.base_type}_{cfg.data.name}.pt"),
                     device=dev)
    explainable(base)
    n_degree = int(base.meta["n_degree"])
    if args.use_cache and args.base_type == "tgat" and \
            base.model.num_layers > C.HOPS:
        raise ValueError(
            f"--use_cache: the walk cache holds {C.HOPS}-hop supports, and "
            f"a {base.model.num_layers}-layer TGAT reads "
            f"{base.model.num_layers} hops; explain it without --use_cache "
            f"or use a {C.HOPS}-layer TGAT")

    print("estimating null motif distribution (shuffled graph)...")
    null_dist = torch.from_numpy(get_null_distribution(
        cfg.data.name, ds.full, n_degree, ds.node_feat, ds.edge_feat,
        cache_dir=args.ckpt_dir, seed=tc.seed, device=dev)).to(dev)
    print("null distribution:", np.round(null_dist.cpu().numpy(), 4))

    if args.base_type == "tgat":
        explainer = TempMETGAT(node_dim=ds.node_feat.shape[1],
                               edge_dim=ds.edge_feat.shape[1],
                               out_dim=ec.out_dim, hid_dim=ec.hid_dim,
                               dropout=ec.dropout, device=dev, seed=tc.seed)
    else:
        explainer = TempME(node_dim=ds.node_feat.shape[1],
                           edge_dim=ds.edge_feat.shape[1], out_dim=ec.out_dim,
                           hid_dim=ec.hid_dim, base_type=args.base_type,
                           dropout=ec.dropout, device=dev, seed=tc.seed)
    print(f"explainer params: "
          f"{sum(x.numel() for x in explainer.parameters()):,} "
          f"device={dev}")
    params = explainer.parameters()
    optimizer = torch.optim.AdamW(params, lr=tc.lr,
                                  weight_decay=tc.weight_decay) \
        if tc.weight_decay else torch.optim.Adam(params, lr=tc.lr)
    generator = torch.Generator(device=dev)
    generator.manual_seed(tc.seed)
    state = loops.TrainState(explainer, optimizer, generator)

    # the negatives' samplers: the walk cache's are seeded from --seed
    samplers = {"train": RandEdgeSampler([ds.train.src], [ds.train.dst],
                                         seed=tc.seed),
                "test": RandEdgeSampler(
                    [ds.train.src, ds.val.src, ds.test.src],
                    [ds.train.dst, ds.val.dst, ds.test.dst], seed=tc.seed)}
    train_step = ExplainerTrainStep(
        explainer, base, g_train, feats,
        torch.from_numpy(samplers["train"].dst_list).to(dev), n_degree,
        null_dist, optimizer, ec.prior_p, ec.beta, bool(args.if_bern))
    eval_step = ExplainerEvalStep(
        explainer, base, g_full, feats,
        torch.from_numpy(samplers["test"].dst_list).to(dev), n_degree,
        null_dist, ec.prior_p, ec.ratios)
    caches = {}
    if args.use_cache:
        caches = open_caches(args.cache_dir, cfg.data.name, n_degree,
                             {"train": (ds.train, g_train),
                              "test": (ds.test, g_full)}, samplers, tc.seed)

    def evaluate(epoch, split):
        ev = run_eval(eval_step, ds.val if split == "val" else ds.test,
                      args.test_bs, bool(args.test_threshold),
                      cache=caches.get(split))
        _print_eval(ev, epoch, split)
        return ev

    ckpt = osp.join(args.ckpt_dir, "explainer", args.base_type,
                    f"{cfg.data.name}.pt")
    name = f"explainer_{args.base_type}_{cfg.data.name}"

    def results(ev):
        write_results(args.results_dir, name,
                      dict(base_type=args.base_type, data=cfg.data.name,
                           n_degree=n_degree, **ev))

    def load_best():
        blob, _ = load_checkpoint(ckpt, map_location=dev)
        explainer.load_state_dict(blob["params"])

    if args.eval_only:
        load_best()
        ev = evaluate(-1, "test")
        results(ev)
        return ev

    train_ckpt = ckpt + ".train_state"
    best, best_ev = 0.0, None
    start_epoch, start_step = 0, 0
    resumed = args.resume and osp.exists(train_ckpt)
    if resumed:
        blob, tmeta = load_checkpoint(train_ckpt, map_location="cpu")
        state.load_state_dict(blob)
        best = tmeta["best"]
        if tmeta.get("step", -1) >= 0:   # mid-epoch (--ckpt_every_steps)
            start_epoch, start_step = tmeta["epoch"], tmeta["step"]
            print(f"resumed from {train_ckpt} at epoch {start_epoch} "
                  f"step {start_step}")
        else:
            start_epoch = tmeta["epoch"] + 1
            print(f"resumed from {train_ckpt} at epoch {start_epoch}")
    logger = MetricsLogger(args.log_dir, run_name=time.strftime(
        f"{args.base_type}_{cfg.data.name}_%Y%m%d_%H%M%S_explainer"))
    bs = tc.batch_size
    cached = "train" in caches
    tp = profiling.Throughput()
    trace_dir = osp.join(args.log_dir, "trace")
    for epoch in range(start_epoch, tc.n_epoch):
        first = start_step if epoch == start_epoch else 0
        if first:
            print(f"  (mid-epoch resume: skipping {first} completed steps)")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        # epoch 0 pays the kernels' loading and the caches' warm-up
        traced = args.profile and epoch == PROFILE_EPOCH
        trace_ctx = profiling.trace(trace_dir) if traced \
            else contextlib.nullcontext()
        trace_ctx.__enter__()
        t0 = time.time()
        tp.start("train")
        auxs, slicing = [], 0.0
        order = loops.epoch_order(len(ds.train), bs, shuffle=True,
                                  seed=tc.seed + epoch) if cached else None
        batches = loops.stack_batches(ds.train, bs, shuffle=True,
                                      seed=tc.seed + epoch, device=dev)
        for i in range(first, batches.src.shape[0]):
            batch = loops.Batch(*(x[i] for x in batches))
            inputs = None
            if cached:                # host time: slicing, copying over
                t_slice = time.perf_counter()
                inputs = C.cache_to_inputs(caches["train"], order[i],
                                           n_degree, dev)
                slicing += time.perf_counter() - t_slice
            auxs.append(train_step(batch, train_step.draw(
                generator, bs, sample=not cached), inputs))
            if args.ckpt_every_steps and \
                    (i + 1) % args.ckpt_every_steps == 0:
                save_checkpoint(train_ckpt, state.state_dict(),
                                meta=dict(epoch=epoch, step=i + 1, best=best))
        agg = {k: torch.stack([a[k] for a in auxs]).cpu().numpy()
               for k in ("loss", "fid_prob", "fid_logit", "y_ori", "y_pred")}
        n_ev = len(auxs) * bs
        rate = tp.stop("train", units=n_ev)   # the steps, through their sync
        trace_ctx.__exit__(None, None, None)
        if traced:
            print(f"profiler trace -> {profiling.latest_trace(trace_dir)}")
        aps = [M.average_precision_score(y, s)
               for y, s in zip(agg["y_ori"], agg["y_pred"])]
        train = {"loss": float(np.mean(agg["loss"])),
                 "aps": float(np.mean(aps)),
                 "fid_prob": float(np.mean(agg["fid_prob"])),
                 "fid_logit": float(np.mean(agg["fid_logit"])),
                 "events_per_s": rate}
        if cached:
            train["cache_slice_ms_per_step"] = slicing / len(auxs) * 1e3
        print(f"epoch {epoch}: loss={train['loss']:.4f} "
              f"aps={train['aps']:.4f} fid_prob={train['fid_prob']:.4f} "
              f"fid_logit={train['fid_logit']:.4f} "
              f"({train['events_per_s']:,.0f} events/s)"
              + (f" cache slicing {train['cache_slice_ms_per_step']:.3f} "
                 f"ms/step" if cached else ""))
        for i, loss in enumerate(agg["loss"]):
            logger.add_scalar("Train/step_loss", float(loss),
                              epoch * (len(ds.train) // bs) + first + i)
        logger.add_scalars("Train", train, epoch)
        # selection on val Ratio-APS; test is reported only
        ev_val = evaluate(epoch, "val")
        ev = evaluate(epoch, "test")
        logger.add_scalars("Val", ev_val, epoch)
        logger.add_scalars("Test", ev, epoch)
        logger.flush()
        score = ev_val["r_aps"] if args.test_threshold else ev_val["aps"]
        # a fresh run always saves its first epoch; a resumed run must
        # strictly beat the restored best
        if (best_ev is None and not resumed) or score > best:
            best, best_ev = score, dict(ev, val_score=score)
            save_checkpoint(ckpt, {"params": explainer.state_dict()},
                            meta=dict(base_type=args.base_type,
                                      data=cfg.data.name, out_dim=ec.out_dim,
                                      hid_dim=ec.hid_dim, drop_out=ec.dropout,
                                      n_degree=n_degree,
                                      node_dim=ds.node_feat.shape[1],
                                      edge_dim=ds.edge_feat.shape[1]))
            print(f"  saved best explainer -> {ckpt} (score={best:.4f})")
        save_checkpoint(train_ckpt, state.state_dict(),
                        meta=dict(epoch=epoch, best=best))
    if args.profile and not start_epoch <= PROFILE_EPOCH < tc.n_epoch:
        print(f"--profile: no epoch traced (epoch index {PROFILE_EPOCH} is "
              f"traced; this run trained epochs {start_epoch} to "
              f"{tc.n_epoch - 1})")
    if best_ev is not None:
        results(best_ev)
    elif resumed:
        # no epoch after the resume beat the saved best: report that one
        load_best()
        results(dict(evaluate(tc.n_epoch, "test"), val_score=best))
    logger.close()
    return best


if __name__ == "__main__":
    main()
