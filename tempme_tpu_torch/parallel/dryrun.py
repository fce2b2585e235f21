"""The sharded dry run: the TGN train step on the ('dp', 'sp', 'tp') mesh,
the explainer, TGAT-explainer and enhance train steps on dp.

    python -m tempme_tpu_torch.parallel.dryrun --world N [--backend gloo] [--device cpu]

Port of ``__graft_entry__.py::dryrun_multichip``: launches N ranks (spawned
processes), runs each sharded train step (``parallel/train.py``) on a tiny
stream (256 events, 32 nodes, width 16, batch 4 a rank, 4 neighbours; the
TGN as the JAX dry run on the mesh ``factorize(N)``: batch 4 a dp index,
``4 sp`` neighbours, width ``16 tp``), and prints the JAX dry run's ``ok``
lines: the TGN's training-form loss
(dropout 0.1, bf16 projections) and, at dropout 0 and float32, its loss and
every memory field of two steps against the 1-process step on the same
global batches and draws at 1e-5; the explainer's (a ``TempME`` on a frozen
TGN), the TGAT explainer's (a ``TempMETGAT`` on a frozen 2-layer TGAT) and
enhance's (a ``TempME`` predictor and a TGN trained jointly) losses at
dropout 0.1; then for each of these three, at dropout 0 and float32, the
loss and every parameter after each of two steps against the 1-process
step at 1e-5. Every rank's state is bitwise equal to rank 0's. It runs on
the card unless ``--device cpu``; the backend is ``nccl`` on the card and
``gloo`` on the CPU unless ``--backend`` says otherwise (under nccl every
rank needs a card of its own).

The pieces serve the tests, ``tools/scaling_report.py`` and
``chip_smoke.py`` too: a *spec* (a ``torch.save`` file) holds the graph,
the features and one or more runs of a step kind (``KINDS``: the model, a
frozen or trained base, the starting state, global batches, optional
global draws, the steps to record and to checkpoint at); ``run_ranks``
replays it on each rank of a process group, ``replay_plain`` on one
process with the 1-process step, and ``launch`` starts the ranks.
"""
from __future__ import annotations

import argparse
import copy
import os
import socket
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..data.events import EventStream
from ..data.graph import build_temporal_graph
from ..explain.tempme import TempME
from ..explain.tempme_tgat import TempMETGAT
from ..models.common import Features
from ..models.graphmixer import GraphMixer
from ..models.tgat import TGAT
from ..models.tgn import TGN, TGNMemoryState, init_memory_state
from ..train import loops
from ..train.base_loader import LoadedBase, load_base
from ..train.enhance_main import EnhanceTrainStep
from ..train.learn_tgn import TGNTrainStep
from ..train.temp_exp_main import ExplainerTrainStep
from ..utils.devices import resolve_device
from ..utils.optim import hold_adam_step
from . import checkpoint, mesh as M, multihost
from .train import (make_sharded_enhance_train_step,
                    make_sharded_explainer_train_step,
                    make_sharded_tgn_train_step)

KINDS = ("tgn", "explainer", "tgat-explainer", "enhance")
# the kernels each kind's path can launch (a TGN step runs no walk kernel)
KERNELS = ("sample_rows", "attend", "attend_drop", "attend_bwd")
WALK_KERNELS = KERNELS + ("sample_union", "sample_masked", "walk_to_edge",
                          "walk_to_edge_bwd")
BASES = {"tgn": TGN, "graphmixer": GraphMixer, "tgat": TGAT}
EXACT_ZERO = ("self_attn.key.bias",)     # gradients zero in exact arithmetic


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(rank, fn, world, init_method, args):
    fn(rank, world, init_method, *args)


def launch(fn, world: int, args=(), timeout: float = 600.0,
           start_method: str = "spawn") -> None:
    """Run ``fn(rank, world, init_method, *args)`` in ``world`` new
    processes (``init_method`` a free ``tcp://localhost`` port). Raises if
    a rank fails or ``timeout`` seconds pass; every process has ended when
    it returns or raises. ``start_method`` "fork" spares each rank its
    imports, and suits only a caller that has not used CUDA or torch's
    thread pools yet (a launcher process of its own)."""
    import torch.multiprocessing as mp
    init = f"tcp://localhost:{free_port()}"
    ctx = mp.start_processes(_rank_entry, args=(fn, world, init, args),
                             nprocs=world, join=False,
                             start_method=start_method)
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


# -- specs ---------------------------------------------------------------
def make_run(model: dict, batches, lr: float = 1e-3, seed: int = 0,
             draws=None, state=None, record=(), save_at=None,
             timed=False, kind: str = "tgn", base=None, null=None,
             restore=None) -> dict:
    """One run of a spec: ``kind`` the step (``KINDS``), ``model`` the
    keyword arguments (without the device) of the trained model (the
    ``TGN``; the ``TempME`` or ``TempMETGAT`` explainer; enhance's
    ``TempME`` predictor), ``base`` the explainer's frozen or enhance's
    trained base (``make_base``, ``checkpoint_base``), ``null`` the
    explainer's motif prior [12], ``batches`` the global batches,
    ``draws`` one global draws
    tuple a step (None: each step draws from the generator, rank r
    seeding it with ``seed + r`` before ``place`` makes it rank 0's),
    ``state`` a train-state blob to start from (any of ``params``,
    ``opt_state``, ``memory``, ``generator``; the rest: the model's seeded
    weights, a fresh Adam, the base's or an empty memory, the seeded
    generator), ``record`` the steps after which the whole state is kept
    (0: before the first), ``save_at`` the step after which
    ``save_sharded`` writes it, ``timed`` to time each step and its
    collectives, ``restore`` a TGN run's ``(ckpt_dir, step)`` whose whole
    state ``restore_sharded`` reads after ``place`` (saved at any mesh)."""
    if kind not in KINDS:
        raise ValueError(f"unknown step kind {kind!r}; one of {KINDS}")
    return dict(kind=kind, model=model, base=base, null=null,
                batches=list(batches), lr=lr, seed=seed, draws=draws,
                state=state, record=tuple(record), save_at=save_at,
                timed=timed, restore=restore)


def make_base(base_type: str, model: dict, params=None, memory=None) -> dict:
    """A run's base: ``base_type`` (``tgn``, ``graphmixer``, ``tgat``), its
    keyword arguments (without the device), its parameters (None: seeded)
    and a TGN's memory (None: empty)."""
    return dict(type=base_type, model=model, params=params, memory=memory)


def checkpoint_base(path: str, compute_dtype=None) -> dict:
    """A run's base read from a base checkpoint by
    ``train/base_loader.py::load_base`` on each rank (``compute_dtype``: a
    TGN's or a TGAT's projections, the loader's default when None)."""
    return dict(path=path, compute_dtype=compute_dtype)


def make_spec(events: EventStream, num_nodes: int, num_edges: int,
              node_feat, edge_feat, dst_table, n: int, runs,
              node_degree=None) -> dict:
    """The graph, features, negatives' table, ``n`` neighbours, the runs,
    and enhance's degree table [N] (None: a degree of 1 at every node)."""
    return dict(events=events, num_nodes=num_nodes, num_edges=num_edges,
                node_feat=np.asarray(node_feat), edge_feat=np.asarray(
                    edge_feat), dst_table=np.asarray(dst_table), n=n,
                runs=list(runs), node_degree=None if node_degree is None
                else np.asarray(node_degree, np.float32))


def load_spec(path: str) -> dict:
    return torch.load(path, weights_only=False)


def _memory(model, blob, dev):
    if blob is not None:
        return TGNMemoryState(**{k: v.to(dev) for k, v in blob.items()})
    return init_memory_state(model.num_nodes, model.memory_dim,
                             model.raw_message_dim, device=dev)


def _loaded_base(cfg: dict, dev, trainable: bool) -> LoadedBase:
    if "path" in cfg:
        return load_base(cfg["path"], dev, cfg["compute_dtype"]
                         or torch.bfloat16, trainable)
    model = BASES[cfg["type"]](**cfg["model"], device=dev)
    if cfg["params"] is not None:
        model.load_state_dict(cfg["params"])
    model.requires_grad_(trainable)
    model.train(trainable)
    mem = _memory(model, cfg["memory"], dev) if cfg["type"] == "tgn" \
        else None
    return LoadedBase(cfg["type"], model, mem, {})


def _build(spec, run, dev) -> dict:
    """A run's graph, features, destination table, models, optimizer and
    memory on ``dev``: ``trained`` the module whose parameters the step
    trains (enhance's: the predictor and the base, in that order, as its
    optimizer's two groups), ``step(mesh)`` its step (None: the 1-process
    one)."""
    g = build_temporal_graph(spec["events"], spec["num_nodes"],
                             spec["num_edges"], device=dev)
    feats = Features(torch.from_numpy(spec["node_feat"]).to(dev),
                     torch.from_numpy(spec["edge_feat"]).to(dev))
    dst = torch.from_numpy(spec["dst_table"]).to(dev)
    kind, n, state = run["kind"], spec["n"], run["state"] or {}
    out = dict(g=g, feats=feats, dst=dst, mem=None)
    if kind == "tgn":
        model = TGN(**run["model"], device=dev)
        out.update(trained=model, mem=_memory(model, state.get("memory"),
                                              dev))
        opt = torch.optim.Adam(model.parameters(), lr=run["lr"])

        def step(mesh):
            if mesh is None:
                return TGNTrainStep(model, g, feats, dst, n, opt)
            return make_sharded_tgn_train_step(model, g, feats, dst, n, opt,
                                               mesh)
    elif kind in ("explainer", "tgat-explainer"):
        base = _loaded_base(run["base"], dev, trainable=False)
        cls = TempMETGAT if kind == "tgat-explainer" else TempME
        explainer = cls(**run["model"], device=dev)
        null = torch.as_tensor(run["null"], dtype=torch.float32).to(dev)
        opt = torch.optim.Adam(explainer.parameters(), lr=run["lr"])
        out.update(trained=explainer)

        def step(mesh):
            if mesh is None:
                return ExplainerTrainStep(explainer, base, g, feats, dst, n,
                                          null, opt)
            return make_sharded_explainer_train_step(
                explainer, base, g, feats, dst, n, null, opt, mesh)
    else:
        base = _loaded_base(run["base"], dev, trainable=True)
        predictor = TempME(**run["model"], device=dev)
        deg = spec.get("node_degree")
        deg = None if deg is None else torch.from_numpy(deg).to(dev)
        opt = torch.optim.Adam(
            [{"params": list(predictor.parameters())},
             {"params": list(base.model.parameters()), "weight_decay": 0.0}],
            lr=run["lr"])
        out.update(trained=torch.nn.ModuleDict(
            {"predictor": predictor, "base": base.model}),
            mem=base.memory if "memory" not in state
            else _memory(base.model, state["memory"], dev))

        def step(mesh):
            if mesh is None:
                return EnhanceTrainStep(predictor, base, g, feats, dst, n,
                                        deg, opt)
            return make_sharded_enhance_train_step(predictor, base, g, feats,
                                                   dst, n, deg, opt, mesh)
    if "params" in state:
        out["trained"].load_state_dict(state["params"])
    if "opt_state" in state:         # Adam updates its state in place
        opt.load_state_dict(copy.deepcopy(state["opt_state"]))
    out.update(opt=opt, step=step)
    return out


def build_run(spec, run, dev):
    """A run's graph, features, destination table, trained model (a
    ``TGN``, an explainer, or enhance's predictor and base as one
    ``ModuleDict``), optimizer and memory (None for an explainer) on
    ``dev``."""
    b = _build(spec, run, dev)
    return b["g"], b["feats"], b["dst"], b["trained"], b["opt"], b["mem"]


def snapshot(model, opt, mem, generator) -> dict:
    """The whole state on the CPU: parameters, gradients, the optimizer's
    state, memory (None for an explainer), generator (a run's ``state``
    can start from it)."""
    return {"params": {k: v.detach().cpu().clone()
                       for k, v in model.state_dict().items()},
            "grads": {k: None if p.grad is None else p.grad.cpu().clone()
                      for k, p in model.named_parameters()},
            "opt_state": copy.deepcopy(checkpoint.to_cpu(opt.state_dict())),
            "memory": None if mem is None else
            {k: v.cpu().clone() for k, v in mem._asdict().items()},
            "generator": generator.get_state()}


def _whole_snapshot(step, mem, generator) -> dict:
    """``snapshot``'s whole state of an sp- or tp-sharded TGN step: the
    memory's row blocks and the tp shards, their gradients and Adam
    moments gathered (every rank calls it)."""
    blob = checkpoint.to_cpu(step.state_dict(mem, generator, grads=True))
    return {"params": {k: v.clone() for k, v in blob["params"].items()},
            "grads": {k: None if g is None else g.clone()
                      for k, g in blob["grads"].items()},
            "opt_state": copy.deepcopy(blob["opt_state"]),
            "memory": {k: v.clone() for k, v in blob["memory"].items()},
            "generator": blob["generator"]}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _kernel_counters(kind: str):
    from ..ops.kernels.attend import attend, attend_bwd, attend_drop
    from ..ops.kernels.sample_masked import sample_masked
    from ..ops.kernels.sample_rows import sample_rows
    from ..ops.kernels.sample_union import sample_union
    from ..ops.kernels.walk_to_edge import walk_to_edge_bwd, walk_to_edge_fwd
    every = dict(zip(WALK_KERNELS, (
        sample_rows, attend, attend_drop, attend_bwd, sample_union,
        sample_masked, walk_to_edge_fwd, walk_to_edge_bwd)))
    names = KERNELS if kind == "tgn" else WALK_KERNELS
    return {name: every[name] for name in names}


def _advance(step, explainer: bool, mem, batch, draws):
    """One step: (new memory, aux); an explainer's has no memory."""
    if explainer:
        return mem, step(batch, draws)
    return step(mem, batch, draws)


def _replay_run(spec, i, run, dev, mesh=None, ckpt_dir=None) -> dict:
    """Replay run ``i`` through the sharded step on ``mesh``, or through
    the 1-process step (``mesh=None``)."""
    b = _build(spec, run, dev)
    model, opt, mem = b["trained"], b["opt"], b["mem"]
    explainer = run["kind"] in ("explainer", "tgat-explainer")
    gen = torch.Generator(device=dev)
    if mesh is None:
        step = b["step"](None)
        gen.manual_seed(run["seed"])
        place_batch = lambda x: _to(x, dev)     # noqa: E731
    else:
        step, place, place_batch = b["step"](mesh)
        gen.manual_seed(run["seed"] + mesh.rank)
    if "generator" in (run["state"] or {}):
        gen.set_state(run["state"]["generator"])
    if mesh is not None:
        if explainer:
            place(gen)
        else:
            mem = place(mem, gen)
    if run.get("restore"):
        ckpt, at = run["restore"]
        blob = checkpoint.restore_sharded(ckpt, at,
                                          step.state_dict(mem, gen))
        mem = step.load_state_dict(blob, gen)
    whole = mesh is not None and step.sharded

    def record():
        if whole:
            return _whole_snapshot(step, mem, gen)
        return snapshot(model, opt, mem, gen)
    comm = None if mesh is None else step.comm
    if comm is not None:
        comm.timed = run["timed"]
    counters = _kernel_counters(run["kind"])
    for f in counters.values():
        f.launches = 0
    out = dict(loss=[], wall_ms=[], comm=[], states={})
    if 0 in run["record"]:
        out["states"][0] = record()
    for k, batch in enumerate(run["batches"], start=1):
        size = batch.src.shape[0]
        draws = run["draws"][k - 1] if run["draws"] is not None \
            else step.draw(gen, size)
        draws = _to(draws, dev)
        local = place_batch(batch)
        if comm is not None:
            comm.reset()
        if run["timed"]:
            _sync(dev)
        t0 = time.perf_counter()
        mem, aux = _advance(step, explainer, mem, local, draws)
        if run["timed"]:
            _sync(dev)
            out["wall_ms"].append((time.perf_counter() - t0) * 1e3)
        out["loss"].append(float(aux["loss"]))
        if comm is not None:
            out["comm"].append(dict(calls=comm.calls, bytes=comm.bytes,
                                    ms=comm.ms, by_kind=dict(comm.by_kind)))
        if k in run["record"]:
            out["states"][k] = record()
        if mesh is not None and run["save_at"] == k:
            state = step.state_dict(gen) if explainer \
                else step.state_dict(mem, gen)
            checkpoint.save_sharded(os.path.join(ckpt_dir, f"run{i}"), state,
                                    k)
    out["launches"] = {name: f.launches for name, f in counters.items()}
    if whole:
        out["local"] = dict(shapes=step.local_shapes(mem),
                            coords=mesh.coords,
                            memory=mem.memory.cpu().clone(),
                            msg_buf=mem.msg_buf.cpu().clone())
    return out


def _to(x, dev):
    if x is None or isinstance(x, torch.Generator):
        return x
    if torch.is_tensor(x):
        return x.to(dev)
    items = [_to(y, dev) for y in x]
    return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)


def replay(spec: dict, mesh, dev, ckpt_dir=None) -> list:
    """Every run of ``spec`` through the sharded step on this rank of
    ``mesh``: per run the global losses, the recorded states, the
    collectives a step (calls by kind, bytes; timed: ms) and the step's
    wall ms (timed); the kernels' launches on this rank."""
    return [_replay_run(spec, i, run, dev, mesh, ckpt_dir)
            for i, run in enumerate(spec["runs"])]


def replay_plain(spec: dict, dev) -> list:
    """Every run of ``spec`` through the 1-process step of its kind
    (``TGNTrainStep``, ``ExplainerTrainStep``, ``EnhanceTrainStep``) on
    the global batches (generator draws seeded with ``seed``)."""
    return [_replay_run(spec, i, run, dev)
            for i, run in enumerate(spec["runs"])]


def run_ranks(rank, world, init_method, backend, device, spec_path,
              out_dir, threads=1, mesh=(0, 1, 1)):
    """One rank (``launch``'s target): join the group, make the ``(dp,
    sp, tp)`` mesh, replay the spec, write ``out_dir/rank{rank}.pt``."""
    torch.set_num_threads(threads)
    dev = multihost.initialize(backend, init_method, world, rank, device)
    try:
        res = replay(load_spec(spec_path), M.make_mesh(*mesh), dev, out_dir)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        multihost.sync("replayed")
    finally:
        dist.destroy_process_group()


def run_spec(spec: dict, world: int, backend: str, device: str,
             work: str, threads: int = 1, timeout: float = 600.0,
             mesh=(0, 1, 1)) -> list:
    """Write ``spec`` under ``work``, replay it on ``world`` ranks of the
    ``(dp, sp, tp)`` mesh (dp 0: the rest), and return every rank's
    results (rank order)."""
    path = os.path.join(work, "spec.pt")
    torch.save(spec, path)
    launch(run_ranks, world, (backend, device, path, work, threads,
                              tuple(mesh)), timeout)
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def assert_ranks_equal(results) -> None:
    """Every rank's losses and recorded states bitwise equal rank 0's (an
    sp- or tp-sharded run records the whole state, gathered from each
    rank's own shards: equal whole states across dp indices hold the
    replicas of each shard equal)."""
    def same(a, b, where):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), where
            for k in a:
                same(a[k], b[k], f"{where}.{k}")
        elif torch.is_tensor(a):
            assert torch.equal(a, b), f"{where} differs between ranks"
        else:
            assert a == b, f"{where}: {a} != {b} between ranks"
    for r, res in enumerate(results[1:], start=1):
        for i, (a, b) in enumerate(zip(results[0], res)):
            same(a["loss"], b["loss"], f"run {i} loss (rank {r})")
            same(a["states"], b["states"], f"run {i} state (rank {r})")


# -- the dry run ---------------------------------------------------------
def _tiny_stream(world: int, num_events=256, num_nodes=32, dn=16, de=8,
                 seed=0, per_rank=4):
    """The JAX dry run's tiny stream (``__graft_entry__._tiny_setup``) and
    two global batches of ``per_rank`` rows a rank after its end."""
    r = np.random.RandomState(seed)
    src = r.randint(1, num_nodes, num_events).astype(np.int32)
    dst = r.randint(1, num_nodes, num_events).astype(np.int32)
    ts = np.sort(r.randint(0, num_events // 2, num_events)).astype(
        np.float32)
    ev = EventStream(src, dst, ts, np.zeros(num_events, np.float32),
                     np.arange(1, num_events + 1, dtype=np.int32))
    nodes, edges = ev.num_nodes, ev.num_edges
    node = np.r_[np.zeros((1, dn)), r.randn(nodes - 1, dn)].astype(np.float32)
    edge = np.r_[np.zeros((1, de)), r.randn(edges - 1, de)].astype(np.float32)
    b = per_rank * world
    r = np.random.RandomState(2)
    batches = [loops.Batch(
        src=torch.from_numpy(r.randint(1, num_nodes, b).astype(np.int32)),
        dst=torch.from_numpy(r.randint(1, num_nodes, b).astype(np.int32)),
        ts=torch.full((b,), float(ts.max()) + 1 + k),
        eidx=torch.from_numpy(r.randint(1, num_events, b).astype(np.int32)),
        mask=torch.ones(b, dtype=torch.bool)) for k in range(2)]
    return ev, node, edge, batches


def tiny_spec(world: int, num_events=256, num_nodes=32, dn=16, de=8,
              seed=0, per_rank=4, n=4, mesh=None) -> dict:
    """The TGN's runs on the tiny stream (``per_rank`` rows a rank, ``n``
    neighbours), two steps each: the training form (dropout 0.1, bf16) and
    the deterministic form (dropout 0, float32). With ``mesh`` (dp, sp,
    tp), as the JAX dry run: ``per_rank`` rows a dp index, ``n * sp``
    neighbours, width ``dn * tp``."""
    if mesh is not None:
        world, n, dn = mesh[0], n * mesh[1], dn * mesh[2]
    ev, node, edge, batches = _tiny_stream(world, num_events, num_nodes, dn,
                                           de, seed, per_rank)
    nodes, edges = ev.num_nodes, ev.num_edges
    model = dict(node_dim=dn, edge_dim=de, num_nodes=nodes, n_layers=2,
                 n_head=2)
    runs = [make_run(dict(model, dropout=0.1), batches),
            make_run(dict(model, dropout=0.0, compute_dtype=torch.float32),
                     batches, record=(0, 1, 2))]
    return make_spec(ev, nodes, edges, node, edge, np.unique(ev.dst), n, runs)


def tiny_walk_spec(world: int, num_events=256, num_nodes=32, dn=16, de=8,
                   seed=0, per_rank=4, n=4) -> dict:
    """The explainer's (a ``TempME`` on a frozen TGN), the TGAT
    explainer's (a ``TempMETGAT`` on a frozen 2-layer TGAT) and enhance's
    (a ``TempME`` predictor with a TGN) runs on the tiny stream, two steps
    each: the training form (dropout 0.1) and the deterministic form
    (dropout 0, float32), out_dim 8, hid_dim 16, the degree table of the
    stream."""
    from ..tools.node_degrees import compute_node_degrees
    ev, node, edge, batches = _tiny_stream(world, num_events, num_nodes, dn,
                                           de, seed, per_rank)
    nodes, edges = ev.num_nodes, ev.num_edges
    tgn = dict(node_dim=dn, edge_dim=de, num_nodes=nodes, n_layers=2,
               n_head=2)
    tgat = dict(node_dim=dn, edge_dim=de, num_layers=2, n_head=2)
    f32 = dict(compute_dtype=torch.float32, dropout=0.0)
    null = np.full(12, 1.0 / 12.0, np.float32)
    exp = dict(node_dim=dn, edge_dim=de, out_dim=8, hid_dim=16)
    runs = []
    for kind, base_type, base in (("explainer", "tgn", tgn),
                                  ("tgat-explainer", "tgat", tgat),
                                  ("enhance", "tgn", tgn)):
        model = exp if kind == "tgat-explainer" else dict(exp,
                                                          base_type="tgn")
        runs += [make_run(dict(model, dropout=0.1), batches, kind=kind,
                          base=make_base(base_type, dict(base, dropout=0.1)),
                          null=null),
                 make_run(dict(model, dropout=0.0), batches, kind=kind,
                          base=make_base(base_type, dict(base, **f32)),
                          null=null, record=(0, 1, 2))]
    return make_spec(ev, nodes, edges, node, edge, np.unique(ev.dst), n, runs,
                     node_degree=compute_node_degrees(ev))


def _tensor(x) -> torch.Tensor:
    return x.detach().cpu() if torch.is_tensor(x) else \
        torch.from_numpy(np.array(x))


def hold_step(got: dict, want: dict, start: dict, what: str,
              lr: float = 1e-3, *, loss_rtol: float = 0.0,
              loss_atol: float = 1e-5, grad_rtol: float = 1e-4,
              grad_atol: float = 1e-5, param_rtol: float = 1e-5,
              param_atol: float = 1e-6, mem_rtol: float = 1e-5,
              mem_atol: float = 1e-5, moments=None,
              exact_zero=EXACT_ZERO, settled=None) -> dict:
    """One step's state ``got`` (its ``loss``, ``grads``, ``params``,
    ``opt_state`` and ``memory`` after the step from ``start``, a
    ``snapshot``) against the reference ``want`` (the same keys, torch
    tensors or numpy arrays; ``opt_state`` only with ``moments``):

    * the loss within ``loss_atol + loss_rtol * |want|``;
    * every gradient rtol ``grad_rtol``, atol ``grad_atol`` of its
      tensor's largest; a gradient that is zero in exact arithmetic
      (``exact_zero``: an attention's key bias, which the softmax cancels)
      is round-off throughout: rtol 0, atol ``grad_atol`` of the model's
      largest, and it never settles;
    * with ``moments`` ({"exp_avg": rtol, "exp_avg_sq": rtol}) Adam's
      moments at that rtol and a tenth of it of the tensor's largest;
    * the parameters rtol ``param_rtol``, atol ``param_atol`` where the
      reference gradient is at least 1e-4 of its tensor's largest (in
      every step so far where ``settled``, a dict kept across steps, is
      given), and every parameter to the float64 replay of Adam (lr
      ``lr``) from ``start`` with ``got``'s own gradient, rtol 1e-5, atol
      1e-6 (``utils/optim.py``: where the gradient is round-off Adam moves
      an entry by up to lr and more either way, so no parameter bound
      holds it); a parameter without a gradient on both sides unchanged;
    * every float memory field rtol ``mem_rtol``, atol ``mem_atol``, the
      flags exactly.

    Returns the worst errors: the loss's over ``|want|``, the gradients'
    over the scale of their atol, the settled parameters', the replays'
    and the memory's."""
    settled = {} if settled is None else settled
    a, b = float(got["loss"]), float(want["loss"])
    assert abs(a - b) <= loss_atol + loss_rtol * abs(b), \
        f"{what}: loss {a}, want {b}"
    worst = dict(loss=abs(a - b) / max(abs(b), 1e-30), grad=0.0, param=0.0,
                 replay=0.0, memory=0.0)
    grads = {n: None if g is None else _tensor(g).double()
             for n, g in want["grads"].items()}
    model_top = max((g.abs().max().item() for g in grads.values()
                     if g is not None), default=0.0)
    for i, (name, ga) in enumerate(got["grads"].items()):
        gb, pa = grads[name], got["params"][name]
        assert (ga is None) == (gb is None), \
            f"{what} {name}: a gradient on one side only"
        if gb is None:
            assert torch.equal(pa, start["params"][name]), \
                f"{what} {name}: moved without a gradient"
            continue
        zero = name.endswith(tuple(exact_zero))
        top = max(gb.abs().max().item(), 1e-30)
        scale = max(model_top, 1e-30) if zero else top
        torch.testing.assert_close(
            ga.double(), gb, rtol=0.0 if zero else grad_rtol,
            atol=grad_atol * scale,
            msg=lambda m: f"{what} {name} grad: {m}")
        worst["grad"] = max(worst["grad"],
                            (ga.double() - gb).abs().max().item() / scale)
        for key, rtol in (moments or {}).items():
            ma = got["opt_state"]["state"][i][key]
            mb = _tensor(want["opt_state"]["state"][i][key])
            mtop = max(mb.abs().max().item(), 1e-30)
            torch.testing.assert_close(
                ma, mb, rtol=rtol, atol=rtol / 10 * mtop,
                msg=lambda m: f"{what} {name} {key}: {m}")
        keep = settled.setdefault(name, torch.ones_like(gb, dtype=torch.bool))
        keep &= (gb.abs() >= 1e-4 * top) & (not zero)
        pb = _tensor(want["params"][name])
        torch.testing.assert_close(
            pa[keep].double(), pb[keep].double(), rtol=param_rtol,
            atol=param_atol, msg=lambda m: f"{what} {name} param: {m}")
        if keep.any():
            worst["param"] = max(worst["param"], (pa.double() - pb.double())[
                keep].abs().max().item())
        worst["replay"] = max(worst["replay"], hold_adam_step(
            pa, start["params"][name], ga,
            start["opt_state"]["state"].get(i), lr, f"{what} {name}"))
    for name, x in (want.get("memory") or {}).items():
        x, y = _tensor(x), got["memory"][name]
        if x.dtype == torch.bool:
            assert torch.equal(y, x), f"{what}: memory {name} differs"
            continue
        torch.testing.assert_close(
            y.double(), x.double(), rtol=mem_rtol, atol=mem_atol,
            msg=lambda m: f"{what} memory {name}: {m}")
        worst["memory"] = max(worst["memory"],
                              (y.double() - x.double()).abs().max().item())
    return worst


def at_step(res: dict, k: int) -> dict:
    """A recorded run's state after step ``k``, with that step's loss."""
    return dict(res["states"][k], loss=res["loss"][k - 1])


def hold_plain(got: dict, plain: dict, what: str, lr: float = 1e-3,
               tol: float = 1e-5) -> None:
    """A recorded run's losses and states after each of its recorded steps
    against the 1-process run's (both recording every step from 0), by
    ``hold_step``: the loss, the parameters (rtol and atol) and the float
    memory within ``tol``, the settled parameters over every step so
    far."""
    settled = {}
    for k in sorted(set(plain["states"]) - {0}):
        hold_step(at_step(got, k), at_step(plain, k), got["states"][k - 1],
                  f"{what}, step {k}", lr, loss_atol=tol, param_rtol=tol,
                  param_atol=tol, mem_rtol=tol, mem_atol=tol,
                  settled=settled)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--backend", choices=multihost.BACKENDS, default=None,
                   help="default: nccl on the card, gloo on the CPU")
    p.add_argument("--device", default=None,
                   help="cpu, or a CUDA device for every rank (default: "
                        "each rank's card)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    backend = args.backend or ("nccl" if dev.type == "cuda" else "gloo")
    w = args.world
    if backend == "nccl" and args.device is None:
        multihost.rank_device(backend, w - 1)     # a card for every rank
    mesh = M.factorize(w)
    print(f"mesh: dp={mesh[0]} sp={mesh[1]} tp={mesh[2]} over {w} ranks "
          f"({backend}, {dev.type}) for the TGN; the explainer, TGAT "
          f"explainer and enhance on dp={w} sp=1 tp=1 (their sp and tp wait "
          f"for ROADMAP A16d)")
    for spec, shape, kinds in ((tiny_spec(w, mesh=mesh), mesh, KINDS[:1]),
                               (tiny_walk_spec(w), (w, 1, 1), KINDS[1:])):
        with tempfile.TemporaryDirectory(prefix="dryrun_") as work:
            results = run_spec(spec, w, backend, args.device, work,
                               mesh=shape)
        assert_ranks_equal(results)
        plain = replay_plain(dict(spec, runs=[
            run for run in spec["runs"] if run["record"]]), dev)
        got = results[0]
        for kind, train_form, checked, want in zip(kinds, got[0::2],
                                                   got[1::2], plain):
            loss = train_form["loss"][0]
            assert np.isfinite(loss), (kind, loss)
            print(f"dryrun_multichip({w}) ok: {kind} loss={loss:.4f} (mesh "
                  f"{'x'.join(map(str, shape))})")
            hold_plain(checked, want, kind)
            what = "loss/parameter" + ("/memory" if kind in ("tgn", "enhance")
                                       else "")
            print(f"dryrun_multichip({w}) ok: {kind} deterministic {what} "
                  f"parity vs 1-device at 1e-5 (2 steps)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
