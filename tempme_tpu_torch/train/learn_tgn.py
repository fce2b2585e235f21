"""TGN link-prediction serving: the eval step and the split evaluator.

Port of ``tempme_tpu/train/learn_tgn.py:76-114`` (``make_tgn_eval_step``,
``evaluate_tgn``). One step masks padded rows, draws negatives and the three
2-hop supports (six ``sample_rows`` launches), advances the memory, runs the
attention pyramid for src, dst and negative (six ``attend`` launches),
scores the affinities, persists the positives, stores the last message per
node and clears padding row 0. The training driver comes with the training
slice.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import metrics as M
from . import loops


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
        bgd, s_src, s_tgt, s_bgd = loops.sample_support(
            self.g, batch, self.dst_table, self.model.n_layers, self.n, draws,
            use_eidx=False)
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
