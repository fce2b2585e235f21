"""The data-parallel TGN train step over ``torch.distributed``.

Port of ``tempme_tpu/parallel/train.py::make_sharded_tgn_train_step`` on a
dp mesh. The JAX step is one global program that XLA partitions; here
every rank runs ``learn_tgn.TGNTrainStep``'s pieces on its contiguous slice
of the global batch, with the state replicated (parameters, Adam state,
memory, generator), and makes the collectives that keep it equal to the
1-process step on the global batch. Four places differ from a naive DDP
wrapper:

(a) Draws. Every rank draws the global batch's draws from the replicated
    generator (``draw``) and keeps its own rows, so the draws are the
    1-process step's and the generators stay in step.
(b) The loss is a mean over the global valid rows: each rank divides its
    masked sums by the global count (padded rows sit on the last rank
    only, so a mean of per-rank means is wrong), the gradients are summed
    over ranks, every parameter taking part (zeros where a rank has no
    gradient; a parameter without a gradient on every rank keeps none, as
    in the 1-process step), and the reported loss is the global one.
(c), (d) The memory. The positives persisted and the messages stored are
    the global batch's: the step all-gathers the batch rows that the
    memory write reads (ids, times, edge ids and the two detached
    embeddings: 2 * B / W rows of the embeddings a rank) and every rank
    runs the model's own ``_persist_positives`` and ``_store_messages`` on
    the global batch, in its global order ``[src_0 .. src_{B-1}, tgt_0 ..
    tgt_{B-1}]``. So a node's message is the one at its largest global
    position (a target on rank 0 beats a source on rank 1), the mean
    aggregator averages over every rank's messages, the persisted
    positives are the union over ranks, and every rank ends the step with
    the same bytes. ``updated_memory`` reads the replicated state only.

Per step a rank makes three collectives: two all-gathers in the forward
(the rows' ids with the masks, whose sum is the global count; the times
and embeddings) and one all-reduce after the backward (every gradient,
their presence flags and the loss in one buffer; the host reads the flags
on the first step only, so later steps do not wait on the card). ``comm``
counts their bytes and, when ``comm.timed``, their wall time.

The memory stays replicated: the row-sharded memory that JAX's ``sp``
gives waits for ROADMAP A16's sp/tp design (``mesh.py``).
"""
from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

from ..models.tgn import TGNMemoryState
from ..train import loops
from ..train.learn_tgn import TGNTrainStep
from .checkpoint import to_cpu
from .mesh import Mesh
from .multihost import local_slice


@dataclasses.dataclass
class CommStats:
    """The collectives' calls, the bytes this rank put in, and (when
    ``timed``: a device sync around each) their wall ms."""
    timed: bool = False
    calls: int = 0
    bytes: int = 0
    ms: float = 0.0

    def reset(self) -> None:
        self.calls, self.bytes, self.ms = 0, 0, 0.0


def shard_draws(draws, world: int, rank: int):
    """This rank's rows of a step's global draws: every tensor's leading
    axis is batch-major (the negatives [B], a hop's [B * n**l, n], a
    layer's dropout [B * n**j, ...]), so rank ``r`` keeps the r-th of
    ``world`` equal chunks."""
    if draws is None:
        return None
    if isinstance(draws, torch.Tensor):
        return draws.chunk(world)[rank] if world > 1 else draws
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


class ShardedTGNTrainStep:
    """``step(mem, batch, draws) -> (new_mem, {"loss", "pos", "neg"})``:
    one Adam step on this rank's slice ``batch`` of the global batch, with
    the global ``draws`` (``draw``). ``loss`` is the global loss; ``pos``
    and ``neg`` are this rank's rows."""

    def __init__(self, model, g, feats, dst_table, n: int, optimizer,
                 mesh: Mesh):
        self.base = TGNTrainStep(model, g, feats, dst_table, n, optimizer)
        self.mesh = mesh
        self.comm = CommStats()
        self.params = list(model.parameters())
        self.local = None        # which parameters this rank gives a grad
        self.present = None      # ... and which any rank does

    # -- collectives ---------------------------------------------------
    def _timed(self, fn, nbytes: int):
        dev = self.params[0].device
        if self.comm.timed and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        if self.comm.timed:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.comm.ms += (time.perf_counter() - t0) * 1e3
        self.comm.calls += 1
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
        return self._timed(run, x.numel() * x.element_size())

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks (in place)."""
        if self.mesh.group is None:
            return x

        def run():
            dist.all_reduce(x, group=self.mesh.group)
            return x
        return self._timed(run, x.numel() * x.element_size())

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

    # -- the step --------------------------------------------------------
    def _check_local(self) -> None:
        """Which parameters get a gradient is fixed by the model's
        configuration (the TGN's forward has no data-dependent branch), so
        the step reads the reduced flags once, on its first call; a change
        of this rank's own pattern after that is an error."""
        local = [p.grad is not None for p in self.params]
        if self.local is None:
            self.local = local
        elif local != self.local:
            raise RuntimeError(
                "the parameters with a gradient changed between steps; the "
                "data-parallel step reads them on its first step only")

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
        self._check_local()
        flat = self.all_reduce(torch.cat(
            [flatten_grads(self.params), loss.detach().reshape(1)]))
        if self.present is None:     # the one host sync, on the first step
            flags = flat[flat.numel() - 1 - len(self.params):-1]
            self.present = [f > 0 for f in flags.tolist()]
        unflatten_grads(self.params, flat[:-1 - len(self.params)],
                        self.present)
        opt.step()
        return self.base.finish(new_mem, flat[-1], pos, neg)

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
        dev = self.params[0].device
        return TGNMemoryState(**{k: v.to(dev)
                                 for k, v in blob["memory"].items()})

    def place(self, mem, generator: torch.Generator):
        """Rank 0's parameters, Adam state, memory and generator state on
        every rank; returns the memory."""
        if self.mesh.group is None:
            return mem
        obj = [None]
        if self.mesh.rank == 0:
            obj[0] = to_cpu(self.state_dict(mem, generator))
        dist.broadcast_object_list(obj, src=0, group=self.mesh.group)
        if self.mesh.rank == 0:
            return mem
        return self.load_state_dict(obj[0], generator)

    def place_batch(self, batch: loops.Batch) -> loops.Batch:
        """This rank's slice of a global batch, on the model's device."""
        dev = self.params[0].device
        sl = local_slice(batch.src.shape[0], self.mesh.rank, self.mesh.size)
        return loops.Batch(*(torch.as_tensor(x)[sl].to(dev) for x in batch))


def make_sharded_tgn_train_step(model, g, feats, dst_table, n: int,
                                optimizer, mesh: Mesh):
    """(step, place, place_batch), as the JAX package's: ``place(mem,
    generator) -> mem`` makes every rank's state rank 0's, ``place_batch``
    takes this rank's slice of a global batch, and ``step(mem, batch,
    step.draw(generator, B))`` is the sharded train step."""
    step = ShardedTGNTrainStep(model, g, feats, dst_table, n, optimizer,
                               mesh)
    return step, step.place, step.place_batch
