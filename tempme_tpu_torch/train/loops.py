"""Batches, padding rules, the per-step random draws, the train state and
the loss.

Port of ``tempme_tpu/train/loops.py:22-161,213-238``, with the
stateless bases' train and eval steps (``make_base_train_step``,
``make_base_eval_step``: TGAT and GraphMixer; the draws are injected as in
the TGN step). Random draws are tensors (``SupportDraws``, ``AttnDraws``,
``MixerDraws``, and ``EnhanceDraws`` for one step of the enhance stage):
``draw_support``, ``draw_dropout`` and ``draw_enhance`` make them from a
``torch.Generator``, and a test can build them from ``jax.random`` in the
JAX package's split order instead.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops import sampler as S
from ..ops.attention import AttnDraws


class Batch(NamedTuple):
    src: torch.Tensor     # [B] int32
    dst: torch.Tensor     # [B] int32
    ts: torch.Tensor      # [B] float32
    eidx: torch.Tensor    # [B] int32
    mask: torch.Tensor    # [B] bool (False = padding row of a final batch)


class SupportDraws(NamedTuple):
    """The random numbers one step consumes: negative indices into the
    destination table, and per side one [B * n**l, n] uniform tensor per
    hop l."""
    neg_idx: torch.Tensor                # [B] int64
    u_src: Tuple[torch.Tensor, ...]
    u_tgt: Tuple[torch.Tensor, ...]
    u_bgd: Tuple[torch.Tensor, ...]


def draw_support(generator: torch.Generator, batch_size: int, k: int, n: int,
                 num_dst: int, device) -> SupportDraws:
    def hops():
        return tuple(torch.rand((batch_size * n ** layer, n),
                                generator=generator, device=device)
                     for layer in range(k))
    neg = torch.randint(0, num_dst, (batch_size,), generator=generator,
                        device=device)
    return SupportDraws(neg, hops(), hops(), hops())


def draw_dropout(generator: torch.Generator, shapes, device,
                 draws_type=AttnDraws):
    """One embedding call's dropout draws: per entry of the model's
    ``dropout_shapes`` (an ``(attn shape, fc shape)`` pair of the TGN or
    the TGAT, a ``MixerDraws`` of shapes of GraphMixer) one ``draws_type``
    of uniforms, drawn in that order."""
    return tuple(draws_type(*(torch.rand(s, generator=generator,
                                         device=device) for s in shapes_i))
                 for shapes_i in shapes)


class EnhanceDraws(NamedTuple):
    """Every random number one enhance step consumes: the negatives and
    the three 2-hop supports, per side the walks' uniforms, then in
    training the base's dropout (per embedding call, src, tgt, bgd; None
    for a TGAT, whose enhance reads no base, or at dropout 0) and per side
    the predictor's (``EnhanceDraws`` of ``explain/tempme.py`` or
    ``TGATEnhanceDraws``; None at dropout 0). Its ``support`` and
    ``walks`` are what ``temp_exp_main.sample_explainer_inputs`` reads."""
    support: SupportDraws
    walks: tuple                       # per side S.WalkDraws
    base: Optional[tuple] = None
    pred: Optional[tuple] = None


def draw_enhance(generator: torch.Generator, batch_size: int, n: int,
                 n_walk_cont: int, num_dst: int, device, base=None,
                 predictor=None) -> EnhanceDraws:
    """One enhance step's draws from ``generator``, in a fixed order: the
    support (2 hops, every base), the walks per side, then the dropout of
    ``base`` (a TGN or a GraphMixer; None: no base draws) and of
    ``predictor`` (None: no predictor draws, as in eval), each only where
    its rate is above 0."""
    support = draw_support(generator, batch_size, 2, n, num_dst, device)
    walks = tuple(S.draw_walks(generator, batch_size, n, n_walk_cont, device)
                  for _ in range(3))
    base_u = pred_u = None
    if base is not None and base.dropout > 0.0:
        shapes = base.dropout_shapes(batch_size, n)
        base_u = tuple(draw_dropout(generator, shapes, device,
                                    getattr(base, "draws_type", AttnDraws))
                       for _ in range(3))
    if predictor is not None and predictor.dropout > 0.0:
        shapes = predictor.enhance_draw_shapes(batch_size, n * n_walk_cont)
        pred_u = tuple(predictor.enhance_draws_type(
            *(torch.rand(s, generator=generator, device=device)
              for s in shapes)) for _ in range(3))
    return EnhanceDraws(support, walks, base_u, pred_u)


class StepDraws(NamedTuple):
    """Every random number one base train step consumes."""
    support: SupportDraws
    dropout: Optional[tuple]   # per embedding call: AttnDraws per layer/block


class TrainState(NamedTuple):
    """What a train step updates: the parameters (in the model), the Adam
    state and the generator of the step's draws."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator

    def state_dict(self) -> dict:
        return {"params": self.model.state_dict(),
                "opt_state": self.optimizer.state_dict(),
                "generator": self.generator.get_state()}

    def load_state_dict(self, blob: dict) -> None:
        self.model.load_state_dict(blob["params"])
        self.optimizer.load_state_dict(blob["opt_state"])
        self.generator.set_state(blob["generator"])


def masked_bce_with_logits(logits, labels, mask, count=None):
    """BCE on ``logits`` [B, 1] averaged over the valid rows only (padded
    final batches). ``count``: the number of valid rows to divide by
    (default: ``mask``'s); the data-parallel step passes the global
    batch's, so that each rank's term is its share of the global mean."""
    per = nn.functional.binary_cross_entropy_with_logits(
        logits.squeeze(-1), labels, reduction="none")
    m = mask.to(per.dtype)
    n = m.sum() if count is None else count
    return (per * m).sum() / n.clamp(min=1.0)


def mask_batch_nodes(batch: Batch) -> Batch:
    """Route padded rows to the padding ids (node 0, edge 0), so their
    memory stores land on row 0, which ``scrub_padding_row`` clears."""
    m = batch.mask
    return Batch(src=torch.where(m, batch.src, 0),
                 dst=torch.where(m, batch.dst, 0),
                 ts=torch.where(m, batch.ts, 0.0),
                 eidx=torch.where(m, batch.eidx, 0),
                 mask=m)


def scrub_padding_row(mem, keep=()):
    """Clear memory row 0 (the padding node) in every field but those
    named in ``keep`` (an sp rank's row blocks that start past it)."""
    out = []
    for name, x in zip(mem._fields, mem):
        x = x.clone()
        if name not in keep:
            x[0] = 0
        out.append(x)
    return type(mem)(*out)


def sample_support(g, batch: Batch, dst_table: torch.Tensor, k: int, n: int,
                   draws: SupportDraws, use_eidx: bool = True,
                   columns=None):
    """Negatives and the three k-hop supports. ``use_eidx=False`` (the base
    models' path) cuts hop 0 at the batch time; ``True`` cuts it at the
    batch event's own edge. ``columns`` as in ``find_k_hop``."""
    bgd = dst_table[draws.neg_idx]
    eidx = batch.eidx if use_eidx else None
    sub_src = S.find_k_hop(g, draws.u_src, batch.src, batch.ts, k, n,
                           eids=eidx, columns=columns)
    sub_tgt = S.find_k_hop(g, draws.u_tgt, batch.dst, batch.ts, k, n,
                           eids=eidx, columns=columns)
    sub_bgd = S.find_k_hop(g, draws.u_bgd, bgd, batch.ts, k, n,
                           columns=columns)
    return bgd, sub_src, sub_tgt, sub_bgd


class BaseTrainStep:
    """The stateless bases' train step (TGAT, GraphMixer): ``step(batch,
    draws) ->
    {"loss", "pos", "neg"}``, one step of ``optimizer`` on the BCE of the
    positive and negative logits over the three ``k``-hop supports (cut at
    the batch time, as the JAX step's ``use_eidx=False``). The gradients
    stay in the parameters' ``.grad`` until the next step."""

    def __init__(self, model, g_train, feats, dst_table: torch.Tensor, k: int,
                 n: int, optimizer: torch.optim.Optimizer):
        self.model, self.g, self.feats = model, g_train, feats
        self.dst_table, self.k, self.n = dst_table, k, n
        self.optimizer = optimizer

    def draw(self, generator: torch.Generator, batch_size: int) -> StepDraws:
        """The step's draws from ``generator`` in a fixed order: the support
        (negatives, then per side the hops), then, when the model has
        dropout, per embedding call (a TGAT's src, tgt, src, bgd; a
        GraphMixer's src, tgt, bgd) and per block its sites' uniforms."""
        dev = self.g.device
        support = draw_support(generator, batch_size, self.k, self.n,
                               self.dst_table.shape[0], dev)
        dropout = None
        if self.model.dropout > 0.0:
            shapes = self.model.dropout_shapes(batch_size, self.n)
            dropout = tuple(draw_dropout(generator, shapes, dev,
                                         self.model.draws_type)
                            for _ in range(self.model.embed_calls))
        return StepDraws(support, dropout)

    def __call__(self, batch: Batch, draws: StepDraws):
        bgd, s_src, s_tgt, s_bgd = sample_support(
            self.g, batch, self.dst_table, self.k, self.n, draws.support,
            use_eidx=False)
        self.optimizer.zero_grad(set_to_none=True)
        pos, neg = self.model.contrast(self.feats, batch.src, batch.dst, bgd,
                                       batch.ts, s_src, s_tgt, s_bgd,
                                       drop=draws.dropout)
        bce = nn.functional.binary_cross_entropy_with_logits
        loss = bce(pos, torch.ones_like(pos)) + bce(neg, torch.zeros_like(neg))
        loss.backward()
        self.optimizer.step()
        return {"loss": loss.detach(), "pos": pos.detach().squeeze(-1),
                "neg": neg.detach().squeeze(-1)}


def make_base_train_step(model, g_train, feats, dst_table, k, n,
                         optimizer) -> BaseTrainStep:
    return BaseTrainStep(model, g_train, feats, dst_table, k, n, optimizer)


class BaseEvalStep:
    """``step(batch, draws) -> (pos [B], neg [B])``: the stateless base's
    logits over freshly sampled ``k``-hop supports, in eval form."""

    def __init__(self, model, g_full, feats, dst_table: torch.Tensor, k: int,
                 n: int):
        self.model, self.g, self.feats = model, g_full, feats
        self.dst_table, self.k, self.n = dst_table, k, n

    def draw(self, generator: torch.Generator,
             batch_size: int) -> SupportDraws:
        return draw_support(generator, batch_size, self.k, self.n,
                            self.dst_table.shape[0], self.g.device)

    @torch.no_grad()
    def __call__(self, batch: Batch, draws: SupportDraws):
        bgd, s_src, s_tgt, s_bgd = sample_support(
            self.g, batch, self.dst_table, self.k, self.n, draws,
            use_eidx=False)
        pos, neg = self.model.contrast(self.feats, batch.src, batch.dst, bgd,
                                       batch.ts, s_src, s_tgt, s_bgd)
        return pos.squeeze(-1), neg.squeeze(-1)


def make_base_eval_step(model, g_full, feats, dst_table, k,
                        n) -> BaseEvalStep:
    return BaseEvalStep(model, g_full, feats, dst_table, k, n)


def epoch_order(n: int, batch_size: int, shuffle: bool,
                seed: int) -> np.ndarray:
    """The event indices of an epoch's full batches, ``[K, B]``: numpy's
    ``RandomState(seed)`` shuffle, as in the JAX package, so both packages
    see the same batches."""
    idx = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    k = n // batch_size
    return idx[:k * batch_size].reshape(k, batch_size)


def stack_batches(events, batch_size: int, shuffle: bool, seed: int,
                  device) -> Batch:
    """All full batches of an epoch (``epoch_order``) as one ``[K, B]``
    Batch on ``device``."""
    idx = epoch_order(len(events), batch_size, shuffle, seed)
    k = idx.shape[0]
    cols = [torch.from_numpy(np.ascontiguousarray(x[idx])).to(device)
            for x in (events.src, events.dst, events.ts, events.e_idx)]
    return Batch(*cols, mask=torch.ones((k, batch_size), dtype=torch.bool,
                                        device=device))


def iter_batches(events, batch_size: int, drop_remainder: bool, device):
    """Fixed-shape batches on ``device``, in time order; a final partial
    batch is padded with event 0 (as in the JAX package) and carries a
    validity mask. The split is copied to the device once."""
    n = len(events)
    idx = np.arange(n)
    if drop_remainder:
        idx = idx[:n - n % batch_size]
    pad = -len(idx) % batch_size
    idx = np.r_[idx, np.zeros(pad, np.int64)]
    cols = [torch.from_numpy(np.ascontiguousarray(x[idx])).to(device)
            for x in (events.src, events.dst, events.ts, events.e_idx)]
    valid = torch.arange(len(idx), device=device) < len(idx) - pad
    for s in range(0, len(idx), batch_size):
        yield Batch(*(c[s:s + batch_size] for c in cols),
                    mask=valid[s:s + batch_size])
