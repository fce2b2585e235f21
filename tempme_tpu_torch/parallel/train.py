"""The sharded train steps over ``torch.distributed``: the TGN's on any
('dp', 'sp', 'tp') mesh, the explainer's and enhance's on dp meshes.

Port of ``tempme_tpu/parallel/train.py`` (``make_sharded_tgn_train_step``,
``make_sharded_explainer_train_step``, ``make_sharded_enhance_train_step``)
on a mesh. The JAX steps are global programs that XLA partitions; here
every rank runs the 1-process step's pieces (``learn_tgn.TGNTrainStep``,
``temp_exp_main.ExplainerTrainStep``, ``enhance_main.EnhanceTrainStep``)
on its dp index's contiguous slice of the global batch, with the state
replicated over dp (parameters, Adam state, a TGN's memory, the
generator) and sharded over sp and tp as (e) and (f) say, and makes the
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

(e) The sp axis (the TGN step): the ranks of one dp index hold the same
    batch rows; each holds one contiguous block of the memory's and the
    message buffer's rows (``RowShard``, ``mesh.row_block``; the flags,
    times and last updates stay whole) and one contiguous chunk of each
    hop's support columns (hop 0 is sampled whole, each deeper hop on the
    chunk of its parent's; the chunks are closed under the pyramid). It
    advances and writes its own rows only; one distributed row gather
    brings the memory rows that the group's embeddings read (forward: the
    requested ids and the owners' rows all-gathered over sp; backward:
    each row's gradient summed at its owner in one all-reduce), the
    layers below the root run on the chunk, and per side one all-gather
    over sp brings the hop-0 embeddings whole for the root. The 1-process
    path is the same code with ``models/tgn.py::WHOLE``'s identity hooks,
    op for op the unsharded pyramid. The draws are cut by the same rows
    and columns (``cut_draws``). The root layer and the head run on every
    rank of the sp group, so each rank weighs its loss by ``1/(sp tp)``.
(f) The tp axis (the TGN step): each rank holds a block of rows of every
    tp-sharded weight (the Dense kernels that JAX's ``shard_params_tp``
    shards, ``utils/convert.py::tp_sharded_names``) and the Adam moments of
    that block only. The step all-gathers the blocks over tp in one bucket,
    runs the forward and backward on whole weights (the tp ranks repeat
    the same work), keeps its rows of each gradient, sums them over the
    ranks with its tp index (``peers``) and steps Adam on its block.
    Replicated parameters sum over the whole world.

At world size 1 the local statistics and draws are the global ones, so the
step makes neither the statistics' all-reduce nor the probabilities'
all-gather. Per step a rank makes, at world size 2 and above
(``GOLDEN_COLLECTIVES``): the TGN step over dp 2 all-gathers (the rows'
ids with the masks; the times and embeddings) and 1 all-reduce (every
gradient, their presence flags and the loss in one buffer; the host reads
the flags on the first step only); sp adds 5 all-gathers (the row
gather's ids and rows; per side the hop-0 embeddings) and 4 all-reduces
(their backwards), tp 1 all-gather (the weights) and, where its tp index has
more than one rank, 1 all-reduce (the shards' gradients); the explainer
step 1 all-reduce of its statistics, 1 all-gather of the probabilities
(none when the gamma draws are passed in) and 1 of the gradients (with the
loss, its parts and the fidelity); a TGAT's explainer no statistics;
enhance the statistics', the TGN's 2 all-gathers and the gradients'.
``comm`` counts them by kind, their bytes and, when ``comm.timed``, their
wall time. The explainer's and enhance's steps run on dp meshes only: their
sp and tp wait for ROADMAP A16d.
"""
from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

from ..explain.tempme import beta_shapes, draw_gamma
from ..models.tgn import WHOLE, TGNMemoryState
from ..train import loops
from ..train.enhance_main import EnhanceTrainStep, enhance_loss
from ..train.learn_tgn import TGNTrainStep
from ..train.temp_exp_main import ExplainerTrainStep
from ..utils.convert import (tp_shard_state_dict, tp_sharded_names,
                             tp_unshard_state_dict)
from .checkpoint import to_cpu
from .mesh import AXES, Mesh, row_block
from .multihost import local_slice

KINDS = ("all_gather", "all_reduce", "broadcast")
# the memory fields whose rows the sp ranks split (the flags, times and
# last updates stay whole, as in JAX), and the Adam moments a tp rank keeps
# the block of
ROW_SHARDED = ("memory", "msg_buf")
MOMENTS = ("exp_avg", "exp_avg_sq")

# the collectives of one step on a rank at world size 2 and above, by kind
# (``utils/debug.py::assert_collectives``); a change of the design changes
# them, and the tests and ``chip_smoke.py`` then fail
GOLDEN_COLLECTIVES = {
    "tgn": dict(all_gather=2, all_reduce=1, broadcast=0),
    "tgn-sp": dict(all_gather=5, all_reduce=5, broadcast=0),
    "tgn-tp": dict(all_gather=1, all_reduce=1, broadcast=0),
    "tgn-dp-sp": dict(all_gather=7, all_reduce=5, broadcast=0),
    "tgn-dp-tp": dict(all_gather=3, all_reduce=2, broadcast=0),
    "tgn-sp-tp": dict(all_gather=6, all_reduce=6, broadcast=0),
    "tgn-dp-sp-tp": dict(all_gather=8, all_reduce=6, broadcast=0),
    "explainer": dict(all_gather=1, all_reduce=2, broadcast=0),
    "explainer-injected-gamma": dict(all_gather=0, all_reduce=2,
                                     broadcast=0),
    "tgat-explainer": dict(all_gather=1, all_reduce=1, broadcast=0),
    "enhance-tgn": dict(all_gather=2, all_reduce=2, broadcast=0),
    "enhance-graphmixer": dict(all_gather=0, all_reduce=2, broadcast=0),
}


def golden_kind(mesh: Mesh, kind: str = "tgn") -> str:
    """The ``GOLDEN_COLLECTIVES`` key of ``kind``'s step on ``mesh``: the
    kind alone on a dp mesh, else with the axes above 1 (``tgn-dp-sp``)."""
    if mesh.sp == 1 and mesh.tp == 1:
        return kind
    return "-".join([kind] + [a for a in AXES if mesh.shape[a] > 1])


def refuse_sp_tp(mesh: Mesh, what: str) -> None:
    """The explainer's and enhance's steps run on dp meshes only."""
    if mesh.sp != 1 or mesh.tp != 1:
        raise ValueError(
            f"the sharded {what} step on mesh sp={mesh.sp} tp={mesh.tp}: "
            f"its sp and tp axes wait for ROADMAP.md A16d (the TGN step "
            f"runs them)")


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


def flatten_grads(params, flagged=None):
    """One float32 buffer of every parameter's gradient (zeros where it has
    none) followed by one presence flag a parameter of ``flagged``
    (``params`` by default; 1 where it has one)."""
    dev = params[0].device
    grads = [(p.grad if p.grad is not None
              else torch.zeros_like(p)).reshape(-1).float()
             for p in params]
    flags = torch.tensor([float(p.grad is not None)
                          for p in (params if flagged is None else flagged)],
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

    @property
    def sharded(self) -> bool:
        """Whether the mesh shards state over sp or tp."""
        return self.mesh.sp > 1 or self.mesh.tp > 1

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

    def all_gather(self, x: torch.Tensor, axis: str = "world"
                   ) -> torch.Tensor:
        """[n * rows, ...]: ``x`` of every rank of ``axis`` (the world or a
        subgroup of the mesh, ``Mesh.axis_group``) in rank order; ``x``
        itself where the axis holds one rank."""
        group = self.mesh.axis_group(axis)
        if group is None:
            return x

        def run():
            parts = [torch.empty_like(x)
                     for _ in range(self.mesh.axis_size(axis))]
            dist.all_gather(parts, x.contiguous(), group=group)
            return torch.cat(parts)
        return self._timed(run, x.numel() * x.element_size(), "all_gather")

    def all_reduce(self, x: torch.Tensor, axis: str = "world"
                   ) -> torch.Tensor:
        """The sum over the ranks of ``axis`` (in place)."""
        group = self.mesh.axis_group(axis)
        if group is None:
            return x

        def run():
            dist.all_reduce(x, group=group)
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

    def reduce_grads(self, extra: torch.Tensor, params=None) -> torch.Tensor:
        """Sum the gradients of ``params`` (every parameter by default) over
        the ranks, in one all-reduce with every parameter's presence flag
        and ``extra`` (a float32 vector: the loss and its parts, each
        rank's share); sets their gradients and returns the summed
        ``extra``."""
        self._check_local()
        params = self.params if params is None else params
        k, n = extra.numel(), len(self.params)
        flat = self.all_reduce(torch.cat(
            [flatten_grads(params, self.params), extra.float()]))
        end = flat.numel() - k
        if self.present is None:     # the one host sync, on the first step
            self.present = [f > 0 for f in flat[end - n:end].tolist()]
        has = dict(zip(map(id, self.params), self.present))
        unflatten_grads(params, flat[:end - n], [has[id(p)] for p in params])
        return flat[end:]

    @property
    def share(self) -> float:
        """This rank's share of the global batch's rows (every rank holds
        as many, ``multihost.local_slice``; a dp mesh's)."""
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
        the global batch's, in dp order (over the ranks with this rank's
        sp and tp indices); puts the global valid count into ``found``."""
        def exchange(src, tgt, cut_time, eidx, src_emb, tgt_emb):
            ids = self.all_gather(torch.stack(
                [src.long(), tgt.long(), eidx.long(), mask.long()], 1), "dp")
            d = src_emb.shape[1]
            vals = self.all_gather(torch.cat(
                [cut_time[:, None].float(), src_emb.float(),
                 tgt_emb.float()], 1), "dp")
            found["count"] = ids[:, 3].sum().to(torch.float32)
            return (ids[:, 0].to(src.dtype), ids[:, 1].to(tgt.dtype),
                    vals[:, 0].to(cut_time.dtype), ids[:, 2].to(eidx.dtype),
                    vals[:, 1:1 + d].to(src_emb.dtype),
                    vals[:, 1 + d:].to(tgt_emb.dtype))
        return exchange

    def place_batch(self, batch: loops.Batch) -> loops.Batch:
        """This rank's dp index's slice of a global batch, on the model's
        device."""
        sl = local_slice(batch.src.shape[0], mesh=self.mesh)
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


class _RowGather(torch.autograd.Function):
    """The rows of a table whose row blocks the sp ranks hold, for the ids
    that any rank of the sp group requests: the requested ids are
    all-gathered over sp, their union (sorted) is split by owner, each
    owner puts its rows of the union in, and one all-gather over sp gives
    every rank the union's rows [U, D] (the same on every rank). The
    backward sums the union's gradient over sp in one all-reduce, and the
    owner keeps its rows."""

    @staticmethod
    def forward(ctx, table, ids, shard):
        step, sp, s = shard.step, shard.size, shard.index
        uniq = torch.unique(step.all_gather(ids, "sp"))
        owner = torch.div(uniq, shard.rows, rounding_mode="floor")
        counts = torch.bincount(owner, minlength=sp).tolist()
        lo = sum(counts[:s])
        mine = uniq[lo:lo + counts[s]] - shard.lo
        resp = table.new_zeros((max(counts), table.shape[1]))
        resp[:counts[s]] = table[mine]
        got = step.all_gather(resp, "sp").reshape(sp, -1, table.shape[1])
        ctx.save_for_backward(mine)
        ctx.shard, ctx.lo, ctx.table_shape = shard, lo, table.shape
        ctx.mark_non_differentiable(uniq)
        return torch.cat([got[r, :counts[r]] for r in range(sp)]), uniq

    @staticmethod
    def backward(ctx, grad, _):
        mine, = ctx.saved_tensors
        g = ctx.shard.step.all_reduce(grad.contiguous().clone(), "sp")
        out = grad.new_zeros(ctx.table_shape)
        out[mine] = g[ctx.lo:ctx.lo + mine.shape[0]]
        return out, None, None


class _ColumnGather(torch.autograd.Function):
    """One side's [B, w, D] column chunk -> [B, sp * w, D]: every sp rank's
    chunk in column order. The backward sums the gradient over sp (each
    rank's root repeats the same work at a weight of 1/sp of the loss) and
    keeps this rank's columns."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        sp, (b, w, d) = shard.size, x.shape
        got = shard.step.all_gather(x, "sp").reshape(sp, b, w, d)
        return got.permute(1, 0, 2, 3).reshape(b, sp * w, d)

    @staticmethod
    def backward(ctx, grad):
        shard = ctx.shard
        g = shard.step.all_reduce(grad.contiguous().clone(), "sp")
        b, w, d = g.shape
        g = g.reshape(b, shard.size, w // shard.size, d)
        return g[:, shard.index].contiguous(), None


class RowShard:
    """This rank's place on the mesh's sp axis for ``TGN.get_node_emb``
    (whose unsharded form is ``models/tgn.py::WHOLE``): its block of
    ``rows`` rows from ``lo`` of a table of ``num_rows``
    (``mesh.row_block``), its chunk of a support's columns, and the
    distributed row and column gathers (their collectives are ``step``'s,
    and counted there)."""

    def __init__(self, step, num_rows: int):
        mesh = step.mesh
        self.step, self.size, self.index = step, mesh.sp, mesh.coords[1]
        self.num_rows = num_rows
        self.lo, self.rows = row_block(num_rows, mesh.sp, self.index)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole table ``x`` [num_rows, ...], zeros
        past its end."""
        part = x[self.lo:self.lo + self.rows]
        short = self.rows - part.shape[0]
        if short:
            part = torch.cat([part, part.new_zeros((short,) + x.shape[1:])])
        return part

    def columns(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous chunk of ``x``'s columns [B, w / sp]
        (contiguous: the sampling kernel reads it)."""
        w = x.shape[1] // self.size
        return x[:, self.index * w:(self.index + 1) * w].contiguous()

    def gather_rows(self, memory: torch.Tensor, node: torch.Tensor, ids):
        """(memory rows, node-feature rows, the map of global ids to them):
        the union of the rows that the sp group's ``ids`` (a list of id
        tensors) read, ``memory`` this rank's block, ``node`` whole; one
        distributed row gather (``_RowGather``)."""
        got, uniq = _RowGather.apply(
            memory, torch.cat([i.reshape(-1).long() for i in ids]), self)
        return got, node[uniq], lambda i: torch.searchsorted(uniq, i.long())

    def gather_columns(self, x: torch.Tensor, b: int) -> torch.Tensor:
        """A side's hop-0 embeddings [B, n, D] from this rank's chunk
        ``x`` of its ``b`` anchors' columns (``_ColumnGather``)."""
        return _ColumnGather.apply(x.reshape(b, -1, x.shape[-1]), self)


def cut_draws(draws, mesh: Mesh, n: int, n_layers: int):
    """This rank's part of a TGN step's global ``StepDraws``: its dp
    index's rows of each (``shard_draws``), and with sp above 1 of every
    array whose rows are a hop's columns its sp chunk: hop l's uniforms
    ``[B * n**l, n]`` (l >= 1) and the dropout of every layer below the
    root ``[B * n**(L-1-i), ...]``; the negatives, hop 0's uniforms and
    the root's dropout stay whole (every sp rank runs them)."""
    d, s, _ = mesh.coords
    rows = shard_draws(draws, mesh.dp, d)
    if mesh.sp == 1:
        return rows

    def cols(x, width):
        y = x.reshape((-1, width) + x.shape[1:])
        w = width // mesh.sp
        return y[:, s * w:(s + 1) * w].reshape(
            (-1,) + x.shape[1:]).contiguous()

    sup = rows.support

    def hops(us):
        return tuple(u if l == 0 else cols(u, n ** l)
                     for l, u in enumerate(us))
    support = loops.SupportDraws(sup.neg_idx, hops(sup.u_src),
                                 hops(sup.u_tgt), hops(sup.u_bgd))
    dropout = rows.dropout
    if dropout is not None:
        dropout = tuple(tuple(
            type(a)(*(x if i == n_layers - 1
                      else cols(x, n ** (n_layers - 1 - i)) for x in a))
            for i, a in enumerate(side)) for side in dropout)
    return loops.StepDraws(support, dropout)


def _gather_parts(step, tensors: dict, axis: str) -> list:
    """``tensors`` (``{key: tensor}``, the same shapes on every rank) of
    every rank of ``axis``, in rank order: one bucketed all-gather."""
    n = step.mesh.axis_size(axis)
    if n == 1:
        return [dict(tensors)]
    flat = torch.cat([x.reshape(-1).float() for x in tensors.values()])
    got = step.all_gather(flat, axis).reshape(n, -1)
    parts = []
    for r in range(n):
        part, off = {}, 0
        for k, x in tensors.items():
            part[k] = got[r, off:off + x.numel()].view_as(x).to(x.dtype)
            off += x.numel()
        parts.append(part)
    return parts


class ShardedTGNTrainStep(DataParallelStep):
    """``step(mem, batch, draws) -> (new_mem, {"loss", "pos", "neg"})``:
    one Adam step on this rank's dp slice ``batch`` of the global batch,
    with the global ``draws`` (``draw``), on a ('dp', 'sp', 'tp') mesh.
    ``loss`` is the global loss; ``pos`` and ``neg`` are this dp index's
    rows. With sp or tp above 1 the state is sharded after ``place``: the
    memory's ``memory`` and ``msg_buf`` are this rank's row block
    (``RowShard``), each tp-sharded weight (``tp_names``) this rank's row
    block, and its Adam moments likewise. ``state_dict`` and ``snapshot``
    gather the whole state; ``load_state_dict`` takes a whole state to this
    rank's shards."""

    def __init__(self, model, g, feats, dst_table, n: int, optimizer,
                 mesh: Mesh):
        super().__init__(model.parameters(), mesh)
        self.base = TGNTrainStep(model, g, feats, dst_table, n, optimizer)
        if n % mesh.sp:
            raise ValueError(f"the sp axis splits each hop's {n} neighbours "
                             f"in contiguous chunks: n={n} is not divisible "
                             f"by sp={mesh.sp}")
        self.shard = RowShard(self, model.num_nodes) if mesh.sp > 1 \
            else WHOLE
        names = dict(model.named_parameters())
        self.tp_names = tp_sharded_names(
            {k: tuple(p.shape) for k, p in names.items()}, mesh.tp)
        self.tp_params = [names[k] for k in self.tp_names]
        tp_ids = {id(p) for p in self.tp_params}
        self.replicated = [p for p in self.params if id(p) not in tp_ids]
        self.scale = 1.0 / (mesh.sp * mesh.tp)
        self.placed = False
        self._whole = {}          # a tp param's whole weight during a step

    def draw(self, generator: torch.Generator, batch_size: int):
        """The global batch's draws (``TGNTrainStep.draw``), the same on
        every rank from the replicated generator."""
        return self.base.draw(generator, batch_size)

    # -- tp ----------------------------------------------------------------
    def _tp_block(self, tensors: dict) -> dict:
        """This rank's tp blocks of whole tensors ``{key: tensor}``
        (``utils/convert.py::tp_shard_state_dict``)."""
        return tp_shard_state_dict(tensors, self.mesh.tp, self.mesh.coords[2],
                                   list(tensors))

    def _tp_whole(self, tensors: dict) -> dict:
        """Whole tensors from every tp rank's blocks ``{key: tensor}`` (one
        all-gather over tp; ``utils/convert.py::tp_unshard_state_dict``)."""
        return tp_unshard_state_dict(_gather_parts(self, tensors, "tp"),
                                     list(tensors))

    def _gather_weights(self) -> None:
        """Every tp-sharded weight whole, its block kept for the
        optimizer."""
        whole = self._tp_whole({k: p.data for k, p in
                                zip(self.tp_names, self.tp_params)})
        for k, p in zip(self.tp_names, self.tp_params):
            self._whole[p] = p.data
            p.data = whole[k]

    def _reduce_shards(self) -> None:
        """This rank's rows of each tp-sharded gradient summed over its
        peers (the ranks with its tp index; the loss weight ``1/(sp tp)``
        undone by ``tp``), and each weight back to its block."""
        grads = self._tp_block({k: p.grad for k, p in
                                zip(self.tp_names, self.tp_params)
                                if p.grad is not None})
        flat = torch.cat([(grads[k] if k in grads
                           else torch.zeros_like(self._whole[p])
                           ).reshape(-1).float()
                          for k, p in zip(self.tp_names, self.tp_params)])
        flat = self.all_reduce(flat, "peers") * float(self.mesh.tp)
        off = 0
        for k, p in zip(self.tp_names, self.tp_params):
            block = self._whole.pop(p)
            n = block.numel()
            p.grad = None
            p.data = block
            if k in grads:
                p.grad = flat[off:off + n].view_as(block).to(block.dtype)
            off += n

    def reduce_grads(self, extra: torch.Tensor) -> torch.Tensor:
        """The replicated parameters' gradients summed over the world in
        one all-reduce with every parameter's presence flag and ``extra``
        (the loss, each rank's weighted share); the tp shards' over their
        peers (``_reduce_shards``). Returns the summed ``extra``."""
        total = super().reduce_grads(extra, self.replicated)
        if self.tp_params:
            self._reduce_shards()
        return total

    # -- the step ------------------------------------------------------------
    def __call__(self, mem, batch: loops.Batch, draws):
        if self.sharded and not self.placed:
            raise RuntimeError("the sp/tp-sharded step runs after place()")
        base, mesh = self.base, self.mesh
        base.optimizer.zero_grad(set_to_none=True)
        if self.tp_params:
            self._gather_weights()
        found = {}
        exchange = self._exchange(batch.mask, found) \
            if mesh.axis_size("dp") > 1 else None
        (pos, neg), new_mem = base.contrast(
            mem, batch, cut_draws(draws, mesh, base.n, base.model.n_layers),
            exchange=exchange, shard=self.shard)
        count = found.get("count")
        if count is None:
            count = batch.mask.sum().to(torch.float32)
        loss = base.loss(pos, neg, batch.mask, count)
        (loss * self.scale if self.scale != 1.0 else loss).backward()
        total = self.reduce_grads(loss.detach().reshape(1) * self.scale)
        base.optimizer.step()
        # padding row 0 sits in the first sp rank's row block only
        return base.finish(new_mem, total[0], pos, neg,
                           ROW_SHARDED if self.shard.lo else ())

    # -- state -----------------------------------------------------------
    def _opt_entries(self):
        """(index in the optimizer's state_dict, parameter) of the tp
        shards."""
        index = {id(p): i for i, p in enumerate(
            p for grp in self.base.optimizer.param_groups
            for p in grp["params"])}
        return [(index[id(p)], p) for p in self.tp_params]

    def _local_state(self, mem, generator):
        return {"params": self.base.model.state_dict(),
                "opt_state": self.base.optimizer.state_dict(),
                "memory": mem._asdict(),
                "generator": generator.get_state()}

    def state_dict(self, mem, generator: torch.Generator,
                   grads: bool = False) -> dict:
        """The whole train state: parameters, Adam state, memory and
        generator (as ``learn_tgn``'s train-state checkpoint); with sp or
        tp above 1 (after ``place``) the memory's row blocks gathered over
        sp and the tp shards with their Adam moments over tp (every rank
        must call it). ``grads``: also every parameter's gradient, whole
        (None where it has none)."""
        blob = self._local_state(mem, generator)
        if grads:
            blob["grads"] = {k: p.grad for k, p in
                             self.base.model.named_parameters()}
        if not (self.sharded and self.placed):
            return blob
        if self.shard is not WHOLE:
            memory = dict(blob["memory"])
            parts = _gather_parts(self, {k: memory[k] for k in ROW_SHARDED},
                                  "sp")
            for k in ROW_SHARDED:
                memory[k] = torch.cat([part[k] for part in parts]
                                      )[:self.shard.num_rows]
            blob["memory"] = memory
        if self.tp_params:
            opt = blob["opt_state"]
            state = dict(opt["state"])
            blocks = {("p", k): blob["params"][k] for k in self.tp_names}
            for i, _ in self._opt_entries():
                blocks.update({(i, m): x for m, x in state.get(i, {}).items()
                               if m in MOMENTS})
            if grads:
                blocks.update({("g", k): p.grad for k, p in
                               zip(self.tp_names, self.tp_params)
                               if p.grad is not None})
            params = dict(blob["params"])
            for (a, b), x in self._tp_whole(blocks).items():
                if a == "p":
                    params[b] = x
                elif a == "g":
                    blob["grads"][b] = x
                else:
                    state[a] = dict(state[a], **{b: x})
            blob["params"] = params
            blob["opt_state"] = dict(opt, state=state)
        return blob

    def _cut(self, mem):
        """This rank's shards of the whole state: the memory's row blocks,
        the tp blocks of the weights and of their Adam moments."""
        if self.shard is not WHOLE:
            mem = mem._replace(**{k: self.shard.local(getattr(mem, k)).clone()
                                  for k in ROW_SHARDED})
        opt = self.base.optimizer.state
        for k, p in zip(self.tp_names, self.tp_params):
            st = opt.get(p, {})
            blocks = self._tp_block(dict(
                {m: x for m, x in st.items() if m in MOMENTS}, **{k: p.data}))
            p.data = blocks.pop(k).clone()
            st.update({m: x.clone() for m, x in blocks.items()})
        return mem

    def load_state_dict(self, blob: dict, generator: torch.Generator):
        """Load a whole state (``state_dict``'s blob, saved at any mesh);
        returns the memory on the model's device, this rank's shards of it
        once the step is placed."""
        if self.placed:
            params = blob["params"]
            for k, p in zip(self.tp_names, self.tp_params):
                p.data = torch.empty(params[k].shape, dtype=p.dtype,
                                     device=p.device)
        self.base.model.load_state_dict(blob["params"])
        self.base.optimizer.load_state_dict(blob["opt_state"])
        generator.set_state(blob["generator"])
        mem = _memory_on(blob["memory"], self.device)
        return self._cut(mem) if self.placed and self.sharded else mem

    def place(self, mem, generator: torch.Generator):
        """Rank 0's parameters, Adam state, memory and generator state on
        every rank, then (sp or tp above 1) this rank's shards of them;
        returns the memory."""
        if self.mesh.group is not None:
            blob = self._broadcast_state(
                lambda: self._local_state(mem, generator))
            if blob is not None:
                mem = self.load_state_dict(blob, generator)
        if self.sharded:
            mem = self._cut(mem)
        self.placed = True
        return mem

    def local_shapes(self, mem) -> dict:
        """What this rank holds at rest: the memory's fields' shapes, each
        tp shard's and its Adam moments'."""
        opt = self.base.optimizer.state
        return {"memory": {k: tuple(v.shape) for k, v in
                           mem._asdict().items()},
                "params": {k: tuple(p.shape) for k, p in zip(
                    self.tp_names, self.tp_params)},
                "moments": {k: {m: tuple(x.shape) for m, x in
                                opt.get(p, {}).items() if m in MOMENTS}
                            for k, p in zip(self.tp_names, self.tp_params)}}


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
        refuse_sp_tp(mesh, "explainer")
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
        refuse_sp_tp(mesh, "enhance")
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
    generator) -> mem`` makes every rank's state rank 0's (and, with sp or
    tp above 1, cuts this rank's shards of it), ``place_batch`` takes this
    rank's dp slice of a global batch, and ``step(mem, batch,
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
