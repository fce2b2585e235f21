"""The data-parallel train steps over ``torch.distributed``: the TGN's,
the explainer's and enhance's.

Port of ``tempme_tpu/parallel/train.py`` (``make_sharded_tgn_train_step``,
``make_sharded_explainer_train_step``, ``make_sharded_enhance_train_step``)
on a dp mesh. The JAX steps are global programs that XLA partitions; here
every rank runs the 1-process step's pieces (``learn_tgn.TGNTrainStep``,
``temp_exp_main.ExplainerTrainStep``, ``enhance_main.EnhanceTrainStep``)
on its contiguous slice of the global batch, with the state replicated
(parameters, Adam state, a TGN's memory, the generator), and makes the
collectives that keep it equal to the 1-process step on the global batch.
What differs from a naive DDP wrapper:

(a) Draws. Every rank draws the global batch's draws from the replicated
    generator (``draw``) and keeps its own rows (``shard_draws``), so the
    draws are the 1-process step's and the generators stay in step. The
    Beta sample's gamma draws depend on the data (a generator's gamma
    sampler consumes its stream by the values of the shapes), so the
    explainer's step all-gathers the edge probabilities (detached) and
    every rank draws on the global shapes and keeps its rows
    (``_global_gamma``).
(b) Losses are means over the global batch: the TGN's over the global
    valid rows (each rank divides its masked sums by the global count;
    padded rows sit on the last rank only), the explainer's and enhance's
    over every global row, padded ones included, as in the JAX steps
    (each rank scales its means by its share of the rows). The gradients
    are summed over ranks, every parameter taking part (zeros where a rank
    has no gradient; a parameter without a gradient on every rank keeps
    none, as in the 1-process step), and the reported losses are the
    global ones.
(c) Batch statistics. The explainer's modules take four statistics over
    the whole batch (``explain/tempme.py``: the time deltas' ``std`` and
    the walks' degrees' mean and ``std``). They read the data only, so
    the step gathers them from the sampled inputs before the forward and
    sums count, sum and sum of squares of each in one float64 all-reduce
    (``reduce_stats``; float32 would cancel: the deltas reach 7e5 s).
(d) The memory. The positives persisted and the messages stored are the
    global batch's: the step all-gathers the batch rows that the memory
    write reads (ids, times, edge ids and the two detached embeddings)
    and every rank runs the model's own ``_persist_positives`` and
    ``_store_messages`` on the global batch, in its global order ``[src_0
    .. src_{B-1}, tgt_0 .. tgt_{B-1}]`` (``_exchange``). So a node's
    message is the one at its largest global position, the mean
    aggregator averages over every rank's messages, the persisted
    positives are the union over ranks, and every rank ends the step with
    the same bytes.

At world size 1 the local statistics and draws are the global ones, so the
step makes neither the statistics' all-reduce nor the probabilities'
all-gather. Per step a rank makes, at world size 2 and above
(``GOLDEN_COLLECTIVES``): the TGN step 2 all-gathers (the rows' ids with
the masks; the times and embeddings) and 1 all-reduce (every gradient,
their presence flags and the loss in one buffer; the host reads the flags
on the first step only); the explainer step 1 all-reduce of its
statistics, 1 all-gather of the probabilities (none when the gamma draws
are passed in) and 1 of the gradients (with the loss, its parts and the
fidelity); a TGAT's explainer no statistics; enhance the statistics',
the TGN's 2 all-gathers and the gradients'. ``comm`` counts them by kind,
their bytes and, when ``comm.timed``, their wall time.

The memory stays replicated: the row-sharded memory that JAX's ``sp``
gives waits for the sp/tp design (``mesh.py``).
"""
from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

from ..explain.tempme import beta_shapes, draw_gamma
from ..models.tgn import TGNMemoryState
from ..train import loops
from ..train.enhance_main import EnhanceTrainStep, enhance_loss
from ..train.learn_tgn import TGNTrainStep
from ..train.temp_exp_main import ExplainerTrainStep
from .checkpoint import to_cpu
from .mesh import Mesh
from .multihost import local_slice

KINDS = ("all_gather", "all_reduce", "broadcast")

# the collectives of one step on a rank at world size 2 and above, by kind
# (``utils/debug.py::assert_collectives``); a change of the design changes
# them, and the tests and ``chip_smoke.py`` then fail
GOLDEN_COLLECTIVES = {
    "tgn": dict(all_gather=2, all_reduce=1, broadcast=0),
    "explainer": dict(all_gather=1, all_reduce=2, broadcast=0),
    "explainer-injected-gamma": dict(all_gather=0, all_reduce=2,
                                     broadcast=0),
    "tgat-explainer": dict(all_gather=1, all_reduce=1, broadcast=0),
    "enhance-tgn": dict(all_gather=2, all_reduce=2, broadcast=0),
    "enhance-graphmixer": dict(all_gather=0, all_reduce=2, broadcast=0),
}


@dataclasses.dataclass
class CommStats:
    """The collectives' calls (in all and ``by_kind``), the bytes this rank
    put in, and (when ``timed``: a device sync around each) their wall
    ms."""
    timed: bool = False
    calls: int = 0
    bytes: int = 0
    ms: float = 0.0
    by_kind: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(KINDS, 0))

    def reset(self) -> None:
        self.calls, self.bytes, self.ms = 0, 0, 0.0
        self.by_kind = dict.fromkeys(KINDS, 0)


def shard_draws(draws, world: int, rank: int):
    """This rank's rows of a step's global draws: every tensor's leading
    axis is batch-major (the negatives [B], a hop's [B * n**l, n], a
    layer's dropout [B * n**j, ...], the walks' [B * n, ...], the gamma
    draws [B, width]), so rank ``r`` keeps the r-th of ``world`` equal
    chunks; a tensor with a leading axis of 1 is shared by the batch's rows
    (a TGAT explainer's attention masks) and stays whole."""
    if draws is None or isinstance(draws, torch.Generator):
        return draws
    if isinstance(draws, torch.Tensor):
        if world == 1 or draws.shape[0] == 1:
            return draws
        return draws.chunk(world)[rank]
    items = [shard_draws(x, world, rank) for x in draws]
    return type(draws)(*items) if hasattr(draws, "_fields") \
        else type(draws)(items)


def flatten_grads(params):
    """One float32 buffer of every parameter's gradient (zeros where it has
    none) followed by one presence flag a parameter (1 where it has one)."""
    dev = params[0].device
    grads = [(p.grad if p.grad is not None
              else torch.zeros_like(p)).reshape(-1).float()
             for p in params]
    flags = torch.tensor([float(p.grad is not None) for p in params],
                         device=dev)
    return torch.cat(grads + [flags])


def unflatten_grads(params, flat, present) -> None:
    """Set each parameter's gradient from ``flatten_grads``' layout, None
    where ``present`` (the reduced flags, as booleans) says no rank had
    one."""
    offset = 0
    for p, has in zip(params, present):
        n = p.numel()
        p.grad = flat[offset:offset + n].view_as(p).to(p.dtype) \
            if has else None
        offset += n


class GlobalStats:
    """The global batch's statistics (``explain/tempme.py``'s ``stats``):
    ``{name: (mean, std)}``, each a 0-dim float32 tensor."""

    def __init__(self, values: dict):
        self.values = values

    def std(self, name: str, x):
        return self.values[name][1].to(x.dtype)

    def mean(self, name: str, x):
        return self.values[name][0].to(x.dtype)


class DataParallelStep:
    """What the sharded steps share: the mesh, the collectives and their
    counts, the gradient all-reduce, the statistics' all-reduce, the
    memory write's exchange, and placing state and batches."""

    def __init__(self, params, mesh: Mesh):
        self.mesh = mesh
        self.comm = CommStats()
        self.params = list(params)
        self.local = None        # which parameters this rank gives a grad
        self.present = None      # ... and which any rank does

    @property
    def device(self):
        return self.params[0].device

    # -- collectives ---------------------------------------------------
    def _timed(self, fn, nbytes: int, kind: str):
        dev = self.device
        if self.comm.timed and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        if self.comm.timed:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.comm.ms += (time.perf_counter() - t0) * 1e3
        self.comm.calls += 1
        self.comm.by_kind[kind] += 1
        self.comm.bytes += nbytes
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[W * rows, ...]: every rank's ``x`` in rank order."""
        if self.mesh.group is None:
            return x

        def run():
            parts = [torch.empty_like(x) for _ in range(self.mesh.size)]
            dist.all_gather(parts, x.contiguous(), group=self.mesh.group)
            return torch.cat(parts)
        return self._timed(run, x.numel() * x.element_size(), "all_gather")

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks (in place)."""
        if self.mesh.group is None:
            return x

        def run():
            dist.all_reduce(x, group=self.mesh.group)
            return x
        return self._timed(run, x.numel() * x.element_size(), "all_reduce")

    def _broadcast_state(self, state_of):
        """Rank 0's ``state_of()`` (a blob of tensors) on every rank, on
        the CPU; None on rank 0 (which keeps its own)."""
        obj = [None]
        nbytes = 0
        if self.mesh.rank == 0:
            obj[0] = to_cpu(state_of())
            nbytes = sum(t.numel() * t.element_size()
                         for t in _tensors(obj[0]))
        self._timed(lambda: dist.broadcast_object_list(
            obj, src=0, group=self.mesh.group), nbytes, "broadcast")
        return None if self.mesh.rank == 0 else obj[0]

    # -- the step's pieces -------------------------------------------------
    def _check_local(self) -> None:
        """Which parameters get a gradient is fixed by the model's
        configuration (no forward here has a data-dependent branch), so
        the step reads the reduced flags once, on its first call; a change
        of this rank's own pattern after that is an error."""
        local = [p.grad is not None for p in self.params]
        if self.local is None:
            self.local = local
        elif local != self.local:
            raise RuntimeError(
                "the parameters with a gradient changed between steps; the "
                "data-parallel step reads them on its first step only")

    def reduce_grads(self, extra: torch.Tensor) -> torch.Tensor:
        """Sum every parameter's gradient over the ranks, in one all-reduce
        with their presence flags and ``extra`` (a float32 vector: the
        loss and its parts, each rank's share); sets the gradients and
        returns the summed ``extra``."""
        self._check_local()
        k, n = extra.numel(), len(self.params)
        flat = self.all_reduce(torch.cat(
            [flatten_grads(self.params), extra.float()]))
        end = flat.numel() - k
        if self.present is None:     # the one host sync, on the first step
            self.present = [f > 0 for f in flat[end - n:end].tolist()]
        unflatten_grads(self.params, flat[:end - n], self.present)
        return flat[end:]

    @property
    def share(self) -> float:
        """This rank's share of the global batch's rows (every rank holds
        as many, ``multihost.local_slice``)."""
        return 1.0 / self.mesh.size

    def reduce_stats(self, sides):
        """Per side a ``GlobalStats`` of the global batch from each side's
        ``{name: tensor}`` (``stat_inputs``): one float64 all-reduce of
        count, sum and sum of squares (the ``std`` with Bessel's
        correction). None at world size 1 (the local statistics are the
        global ones) or when no side has a statistic."""
        keys = [(i, name) for i, side in enumerate(sides) for name in side]
        if self.mesh.size == 1 or not keys:
            return None
        rows = []
        for i, name in keys:
            x = sides[i][name].detach().double()
            rows.append(torch.stack([x.new_tensor(float(x.numel())),
                                     x.sum(), (x * x).sum()]))
        n, s, ss = self.all_reduce(torch.stack(rows)).unbind(1)
        mean = s / n
        std = ((ss - s * mean) / (n - 1)).clamp(min=0.0).sqrt()
        out = [dict() for _ in sides]
        for j, (i, name) in enumerate(keys):
            out[i][name] = (mean[j].float(), std[j].float())
        return tuple(GlobalStats(v) for v in out)

    def _exchange(self, mask, found: dict):
        """The ``exchange`` of ``TGN.get_node_emb``: this rank's rows ->
        the global batch's, in rank order; puts the global valid count
        into ``found``."""
        def exchange(src, tgt, cut_time, eidx, src_emb, tgt_emb):
            ids = self.all_gather(torch.stack(
                [src.long(), tgt.long(), eidx.long(), mask.long()], 1))
            d = src_emb.shape[1]
            vals = self.all_gather(torch.cat(
                [cut_time[:, None].float(), src_emb.float(),
                 tgt_emb.float()], 1))
            found["count"] = ids[:, 3].sum().to(torch.float32)
            return (ids[:, 0].to(src.dtype), ids[:, 1].to(tgt.dtype),
                    vals[:, 0].to(cut_time.dtype), ids[:, 2].to(eidx.dtype),
                    vals[:, 1:1 + d].to(src_emb.dtype),
                    vals[:, 1 + d:].to(tgt_emb.dtype))
        return exchange

    def place_batch(self, batch: loops.Batch) -> loops.Batch:
        """This rank's slice of a global batch, on the model's device."""
        sl = local_slice(batch.src.shape[0], self.mesh.rank, self.mesh.size)
        return loops.Batch(*(torch.as_tensor(x)[sl].to(self.device)
                             for x in batch))


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _memory_on(blob_memory, dev):
    return None if blob_memory is None else TGNMemoryState(
        **{k: v.to(dev) for k, v in blob_memory.items()})


class ShardedTGNTrainStep(DataParallelStep):
    """``step(mem, batch, draws) -> (new_mem, {"loss", "pos", "neg"})``:
    one Adam step on this rank's slice ``batch`` of the global batch, with
    the global ``draws`` (``draw``). ``loss`` is the global loss; ``pos``
    and ``neg`` are this rank's rows."""

    def __init__(self, model, g, feats, dst_table, n: int, optimizer,
                 mesh: Mesh):
        super().__init__(model.parameters(), mesh)
        self.base = TGNTrainStep(model, g, feats, dst_table, n, optimizer)

    def draw(self, generator: torch.Generator, batch_size: int):
        """The global batch's draws (``TGNTrainStep.draw``), the same on
        every rank from the replicated generator."""
        return self.base.draw(generator, batch_size)

    def __call__(self, mem, batch: loops.Batch, draws):
        opt = self.base.optimizer
        opt.zero_grad(set_to_none=True)
        found = {}
        (pos, neg), new_mem = self.base.contrast(
            mem, batch, shard_draws(draws, self.mesh.size, self.mesh.rank),
            exchange=self._exchange(batch.mask, found))
        loss = self.base.loss(pos, neg, batch.mask, found["count"])
        loss.backward()
        total = self.reduce_grads(loss.detach().reshape(1))
        opt.step()
        return self.base.finish(new_mem, total[0], pos, neg)

    # -- state -----------------------------------------------------------
    def state_dict(self, mem, generator: torch.Generator) -> dict:
        """The replicated train state: parameters, Adam state, memory and
        generator (as ``learn_tgn``'s train-state checkpoint)."""
        return {"params": self.base.model.state_dict(),
                "opt_state": self.base.optimizer.state_dict(),
                "memory": mem._asdict(),
                "generator": generator.get_state()}

    def load_state_dict(self, blob: dict, generator: torch.Generator):
        """Load ``state_dict``'s blob; returns the memory on the model's
        device."""
        self.base.model.load_state_dict(blob["params"])
        self.base.optimizer.load_state_dict(blob["opt_state"])
        generator.set_state(blob["generator"])
        return _memory_on(blob["memory"], self.device)

    def place(self, mem, generator: torch.Generator):
        """Rank 0's parameters, Adam state, memory and generator state on
        every rank; returns the memory."""
        if self.mesh.group is None:
            return mem
        blob = self._broadcast_state(lambda: self.state_dict(mem, generator))
        return mem if blob is None else self.load_state_dict(blob, generator)


class ShardedExplainerTrainStep(DataParallelStep):
    """``step(batch, draws) -> aux``: one optimizer step of the explainer
    (``TempME`` over a TGN or a GraphMixer, ``TempMETGAT`` over a TGAT) on
    this rank's slice ``batch`` of the global batch, with the global
    ``draws`` (``draw``); the frozen base (and a TGN's memory) is
    replicated and only read. ``loss``, ``pred_loss``, ``kl`` and the
    fidelities in the aux dict are the global batch's; ``y_ori`` and
    ``y_pred`` this rank's rows."""

    def __init__(self, explainer, base, g, feats, dst_table, n_degree: int,
                 null_dist, optimizer, mesh: Mesh, beta: float = 0.5,
                 prior_p: float = 0.3):
        super().__init__(explainer.parameters(), mesh)
        self.base = ExplainerTrainStep(explainer, base, g, feats, dst_table,
                                       n_degree, null_dist, optimizer,
                                       prior_p, beta)

    def draw(self, generator: torch.Generator, batch_size: int):
        """The global batch's draws (``ExplainerTrainStep.draw``; the gamma
        draws come from ``generator`` inside the step)."""
        return self.base.draw(generator, batch_size)

    def _global_gamma(self, generator: torch.Generator):
        """The gamma source of ``retrieve_explanation``: every side's
        per-hop edge probabilities all-gathered (detached) in one call,
        the draws taken on the global shapes in the 1-process step's order
        (per side, per hop, ga then gb), this rank's rows kept."""
        def draw(probs):
            flat = [p.detach() for side in probs for p in side]
            rows = flat[0].shape[0]
            lo = self.mesh.rank * rows
            every = self.all_gather(torch.cat(flat, 1)).split(
                [p.shape[1] for p in flat], 1)
            out, k = [], 0
            for side in probs:
                side_draws = []
                for _ in side:
                    ga, gb = draw_gamma(*beta_shapes(every[k]), generator)
                    side_draws += [ga[lo:lo + rows], gb[lo:lo + rows]]
                    k += 1
                out.append(tuple(side_draws))
            return out
        return draw

    def _local_draws(self, draws):
        w, r = self.mesh.size, self.mesh.rank
        gamma = draws.gamma
        if w > 1 and isinstance(gamma, torch.Generator):
            gamma = self._global_gamma(gamma)
        else:
            gamma = shard_draws(gamma, w, r)
        return shard_draws(draws._replace(gamma=None), w, r)._replace(
            gamma=gamma)

    def __call__(self, batch: loops.Batch, draws):
        step = self.base
        step.optimizer.zero_grad(set_to_none=True)
        local = self._local_draws(draws)
        inputs = step.sample(batch, local)
        stats = self.reduce_stats([step.explainer.stat_inputs(w, batch.ts)
                                   for w in inputs[2]])
        out = step._forward(batch, local, step.if_bern, inputs, stats)
        loss, pred_loss, y_ori, pred = step.losses(out)
        share = self.share
        (loss * share).backward()
        parts = torch.stack([loss.detach(), pred_loss.detach(),
                             out["kl"].detach(), *step.fidelity(out)])
        total = self.reduce_grads(parts * share)
        step.optimizer.step()
        return step.finish(total[0], total[1], total[2], y_ori, pred,
                           total[3], total[4])

    # -- state -----------------------------------------------------------
    def state_dict(self, generator: torch.Generator) -> dict:
        """The replicated train state: the explainer's parameters, its
        optimizer's state and the generator."""
        return {"params": self.base.explainer.state_dict(),
                "opt_state": self.base.optimizer.state_dict(),
                "generator": generator.get_state()}

    def load_state_dict(self, blob: dict, generator: torch.Generator):
        self.base.explainer.load_state_dict(blob["params"])
        self.base.optimizer.load_state_dict(blob["opt_state"])
        generator.set_state(blob["generator"])

    def place(self, generator: torch.Generator) -> None:
        """Rank 0's explainer, optimizer state and generator state on every
        rank (the frozen base is the same checkpoint on every rank)."""
        if self.mesh.group is None:
            return
        blob = self._broadcast_state(lambda: self.state_dict(generator))
        if blob is not None:
            self.load_state_dict(blob, generator)


class ShardedEnhanceTrainStep(DataParallelStep):
    """``step(mem, batch, draws, train_base=True) -> (new_mem, {"loss",
    "pos", "neg"})``: one joint optimizer step of the predictor and the
    base (a TGN, whose memory the step writes from the global batch, or a
    GraphMixer) on this rank's slice ``batch`` of the global batch, with
    the global ``draws``. ``loss`` is the global loss; ``pos`` and ``neg``
    are this rank's rows; every parameter takes a gradient (zeros where
    the step did not reach it, as in ``EnhanceTrainStep``)."""

    def __init__(self, predictor, base, g, feats, dst_table, n_degree: int,
                 node_degree, optimizer, mesh: Mesh):
        super().__init__((p for group in optimizer.param_groups
                          for p in group["params"]), mesh)
        self.base = EnhanceTrainStep(predictor, base, g, feats, dst_table,
                                     n_degree, node_degree, optimizer)

    def draw(self, generator: torch.Generator, batch_size: int):
        return self.base.draw(generator, batch_size)

    def __call__(self, mem, batch: loops.Batch, draws,
                 train_base: bool = True):
        step = self.base
        step.optimizer.zero_grad(set_to_none=True)
        local = shard_draws(draws, self.mesh.size, self.mesh.rank)
        inputs = step.sample(batch, local)
        stats = self.reduce_stats([
            step.predictor.stat_inputs(w, batch.ts, step.node_degree,
                                       enhance=True) for w in inputs[2]])
        exchange = self._exchange(batch.mask, {}) if step.is_tgn else None
        (pos, neg), new_mem = step._forward(mem, batch, local, train_base,
                                            inputs, stats, exchange)
        loss = enhance_loss(pos, neg)
        share = self.share
        (loss * share).backward()
        step.zero_missing_grads()
        total = self.reduce_grads(loss.detach().reshape(1) * share)
        step.optimizer.step()
        return step.finish(new_mem, total[0], pos, neg)

    # -- state -----------------------------------------------------------
    def state_dict(self, mem, generator: torch.Generator) -> dict:
        """The replicated train state: both models' parameters, the
        optimizer's state, a TGN's memory (else None) and the
        generator."""
        base = self.base.base.model
        return {"params": {"predictor": self.base.predictor.state_dict(),
                           "base": base.state_dict()},
                "opt_state": self.base.optimizer.state_dict(),
                "memory": None if mem is None else mem._asdict(),
                "generator": generator.get_state()}

    def load_state_dict(self, blob: dict, generator: torch.Generator):
        """Load ``state_dict``'s blob; returns the memory (or None) on the
        model's device."""
        self.base.predictor.load_state_dict(blob["params"]["predictor"])
        self.base.base.model.load_state_dict(blob["params"]["base"])
        self.base.optimizer.load_state_dict(blob["opt_state"])
        generator.set_state(blob["generator"])
        return _memory_on(blob["memory"], self.device)

    def place(self, mem, generator: torch.Generator):
        """Rank 0's parameters, optimizer state, memory and generator state
        on every rank; returns the memory."""
        if self.mesh.group is None:
            return mem
        blob = self._broadcast_state(lambda: self.state_dict(mem, generator))
        return mem if blob is None else self.load_state_dict(blob, generator)


def make_sharded_tgn_train_step(model, g, feats, dst_table, n: int,
                                optimizer, mesh: Mesh):
    """(step, place, place_batch), as the JAX package's: ``place(mem,
    generator) -> mem`` makes every rank's state rank 0's, ``place_batch``
    takes this rank's slice of a global batch, and ``step(mem, batch,
    step.draw(generator, B))`` is the sharded train step."""
    step = ShardedTGNTrainStep(model, g, feats, dst_table, n, optimizer,
                               mesh)
    return step, step.place, step.place_batch


def make_sharded_explainer_train_step(explainer, base, g, feats, dst_table,
                                      n_degree: int, null_dist, optimizer,
                                      mesh: Mesh, beta: float = 0.5,
                                      prior_p: float = 0.3):
    """(step, place, place_batch) of the explainer: ``base`` the frozen
    ``LoadedBase`` (the JAX package takes its contrast function; here the
    step makes it), ``place(generator)`` makes every rank's explainer,
    optimizer state and generator rank 0's, and ``step(batch,
    step.draw(generator, B))`` is the sharded train step."""
    step = ShardedExplainerTrainStep(explainer, base, g, feats, dst_table,
                                     n_degree, null_dist, optimizer, mesh,
                                     beta, prior_p)
    return step, step.place, step.place_batch


def make_sharded_enhance_train_step(predictor, base, g, feats, dst_table,
                                    n_degree: int, node_degree, optimizer,
                                    mesh: Mesh):
    """(step, place, place_batch) of enhance on a TGN or a GraphMixer
    ``base`` (a ``LoadedBase``, trained jointly): ``place(mem, generator)
    -> mem`` makes every rank's state rank 0's, and ``step(mem, batch,
    step.draw(generator, B))`` is the sharded train step."""
    if base is None or base.base_type not in ("tgn", "graphmixer"):
        raise ValueError("the data-parallel enhance step takes a TGN or a "
                         "GraphMixer base, as the JAX package's")
    step = ShardedEnhanceTrainStep(predictor, base, g, feats, dst_table,
                                   n_degree, node_degree, optimizer, mesh)
    return step, step.place, step.place_batch
