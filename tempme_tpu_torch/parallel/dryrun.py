"""The data-parallel dry run of the TGN train step.

    python -m tempme_tpu_torch.parallel.dryrun --world N [--backend gloo] [--device cpu]

Port of the TGN half of ``__graft_entry__.py::dryrun_multichip``: launches
N ranks (spawned processes), runs the sharded TGN train step
(``parallel/train.py``) on a tiny stream (256 events, 32 nodes, width 16,
batch 4 a rank, 4 neighbours), and prints the JAX dry run's ``ok`` lines
for the TGN: the training form's loss (dropout 0.1, bf16 projections),
then, at dropout 0 and float32, the loss and every memory field of two
steps against the 1-process step (``learn_tgn.TGNTrainStep``) on the same
global batches and draws at 1e-5, and every rank's state bitwise equal to
rank 0's. It runs on the card unless ``--device cpu``; the backend is
``nccl`` on the card and ``gloo`` on the CPU unless ``--backend`` says
otherwise (under nccl every rank needs a card of its own). The explainer,
TGAT-explainer and enhance checks of the JAX dry run are not ported yet
(ROADMAP A16b); the run says so.

The pieces serve the tests and ``chip_smoke.py`` too: a *spec* (a
``torch.save`` file) holds the graph, the features and one or more runs
(model, starting state, global batches, optional global draws, the steps to
record and to checkpoint at); ``run_ranks`` replays it on each rank of a
process group, ``replay_plain`` on one process with the plain step, and
``launch`` starts the ranks.
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
from ..models.common import Features
from ..models.tgn import TGN, TGNMemoryState, init_memory_state
from ..train import loops
from ..train.learn_tgn import TGNTrainStep
from ..utils.devices import resolve_device
from . import checkpoint, mesh as M, multihost
from .train import make_sharded_tgn_train_step

KERNELS = ("sample_rows", "attend", "attend_drop", "attend_bwd")
NOT_PORTED = ("explainer", "TGAT-explainer", "enhance")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(rank, fn, world, init_method, args):
    fn(rank, world, init_method, *args)


def launch(fn, world: int, args=(), timeout: float = 600.0) -> None:
    """Run ``fn(rank, world, init_method, *args)`` in ``world`` spawned
    processes (``init_method`` a free ``tcp://localhost`` port). Raises if
    a rank fails or ``timeout`` seconds pass; every process has ended when
    it returns or raises."""
    import torch.multiprocessing as mp
    init = f"tcp://localhost:{free_port()}"
    ctx = mp.start_processes(_rank_entry, args=(fn, world, init, args),
                             nprocs=world, join=False, start_method="spawn")
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
             timed=False) -> dict:
    """One run of a spec: ``model`` the ``TGN`` keyword arguments (without
    the device), ``batches`` the global batches, ``draws`` one global
    ``StepDraws`` a step (None: each step draws from the generator, rank r
    seeding it with ``seed + r`` before ``place`` makes it rank 0's),
    ``state`` a train-state blob to start from (any of ``params``,
    ``opt_state``, ``memory``, ``generator``; the rest: the model's seeded
    weights, a fresh Adam, an empty memory, the seeded generator),
    ``record`` the steps after which the whole state is kept (0: before
    the first),
    ``save_at`` the step after which ``save_sharded`` writes it, ``timed``
    to time each step and its collectives."""
    return dict(model=model, batches=list(batches), lr=lr, seed=seed,
                draws=draws, state=state, record=tuple(record),
                save_at=save_at, timed=timed)


def make_spec(events: EventStream, num_nodes: int, num_edges: int,
              node_feat, edge_feat, dst_table, n: int, runs) -> dict:
    return dict(events=events, num_nodes=num_nodes, num_edges=num_edges,
                node_feat=np.asarray(node_feat), edge_feat=np.asarray(
                    edge_feat), dst_table=np.asarray(dst_table), n=n,
                runs=list(runs))


def load_spec(path: str) -> dict:
    return torch.load(path, weights_only=False)


def build_run(spec, run, dev):
    """A run's graph, features, destination table, model, Adam and
    memory on ``dev``."""
    g = build_temporal_graph(spec["events"], spec["num_nodes"],
                             spec["num_edges"], device=dev)
    feats = Features(torch.from_numpy(spec["node_feat"]).to(dev),
                     torch.from_numpy(spec["edge_feat"]).to(dev))
    dst = torch.from_numpy(spec["dst_table"]).to(dev)
    model = TGN(**run["model"], device=dev)
    opt = torch.optim.Adam(model.parameters(), lr=run["lr"])
    mem = init_memory_state(model.num_nodes, model.memory_dim,
                            model.raw_message_dim, device=dev)
    state = run["state"] or {}
    if "params" in state:
        model.load_state_dict(state["params"])
    if "opt_state" in state:         # Adam updates its state in place
        opt.load_state_dict(copy.deepcopy(state["opt_state"]))
    if "memory" in state:
        mem = TGNMemoryState(**{k: v.to(dev)
                                for k, v in state["memory"].items()})
    return g, feats, dst, model, opt, mem


def snapshot(model, opt, mem, generator) -> dict:
    """The whole state on the CPU: parameters, gradients, Adam, memory,
    generator (a run's ``state`` can start from it)."""
    return {"params": {k: v.detach().cpu().clone()
                       for k, v in model.state_dict().items()},
            "grads": {k: None if p.grad is None else p.grad.cpu().clone()
                      for k, p in model.named_parameters()},
            "opt_state": copy.deepcopy(checkpoint.to_cpu(opt.state_dict())),
            "memory": {k: v.cpu().clone() for k, v in mem._asdict().items()},
            "generator": generator.get_state()}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _kernel_counters():
    from ..ops.kernels.attend import attend, attend_bwd, attend_drop
    from ..ops.kernels.sample_rows import sample_rows
    return dict(zip(KERNELS, (sample_rows, attend, attend_drop, attend_bwd)))


def _replay_run(spec, i, run, dev, mesh=None, ckpt_dir=None) -> dict:
    """Replay run ``i`` through the sharded step on ``mesh``, or through
    the 1-process ``TGNTrainStep`` (``mesh=None``)."""
    g, feats, dst, model, opt, mem = build_run(spec, run, dev)
    gen = torch.Generator(device=dev)
    if mesh is None:
        step = TGNTrainStep(model, g, feats, dst, spec["n"], opt)
        gen.manual_seed(run["seed"])
        place_batch = lambda b: _to(b, dev)     # noqa: E731
    else:
        step, place, place_batch = make_sharded_tgn_train_step(
            model, g, feats, dst, spec["n"], opt, mesh)
        gen.manual_seed(run["seed"] + mesh.rank)
    if "generator" in (run["state"] or {}):
        gen.set_state(run["state"]["generator"])
    if mesh is not None:
        mem = place(mem, gen)
    comm = None if mesh is None else step.comm
    if comm is not None:
        comm.timed = run["timed"]
    counters = _kernel_counters()
    for f in counters.values():
        f.launches = 0
    out = dict(loss=[], wall_ms=[], comm=[], states={})
    if 0 in run["record"]:
        out["states"][0] = snapshot(model, opt, mem, gen)
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
        mem, aux = step(mem, local, draws)
        if run["timed"]:
            _sync(dev)
            out["wall_ms"].append((time.perf_counter() - t0) * 1e3)
        out["loss"].append(float(aux["loss"]))
        if comm is not None:
            out["comm"].append(dict(calls=comm.calls, bytes=comm.bytes,
                                    ms=comm.ms))
        if k in run["record"]:
            out["states"][k] = snapshot(model, opt, mem, gen)
        if mesh is not None and run["save_at"] == k:
            checkpoint.save_sharded(os.path.join(ckpt_dir, f"run{i}"),
                                    step.state_dict(mem, gen), k)
    out["launches"] = {name: f.launches for name, f in counters.items()}
    return out


def _to(x, dev):
    if x is None:
        return None
    if torch.is_tensor(x):
        return x.to(dev)
    items = [_to(y, dev) for y in x]
    return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)


def replay(spec: dict, mesh, dev, ckpt_dir=None) -> list:
    """Every run of ``spec`` through the sharded step on this rank of
    ``mesh``: per run the global losses, the recorded states, and (timed)
    the step and collective times; the kernels' launches on this rank."""
    return [_replay_run(spec, i, run, dev, mesh, ckpt_dir)
            for i, run in enumerate(spec["runs"])]


def replay_plain(spec: dict, dev) -> list:
    """Every run of ``spec`` through the 1-process ``TGNTrainStep`` on the
    global batches (generator draws seeded with ``seed``)."""
    return [_replay_run(spec, i, run, dev)
            for i, run in enumerate(spec["runs"])]


def run_ranks(rank, world, init_method, backend, device, spec_path,
              out_dir, threads=1):
    """One rank (``launch``'s target): join the group, replay the spec,
    write ``out_dir/rank{rank}.pt``."""
    torch.set_num_threads(threads)
    dev = multihost.initialize(backend, init_method, world, rank, device)
    try:
        res = replay(load_spec(spec_path), M.make_mesh(), dev, out_dir)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        multihost.sync("replayed")
    finally:
        dist.destroy_process_group()


def run_spec(spec: dict, world: int, backend: str, device: str,
             work: str, threads: int = 1, timeout: float = 600.0) -> list:
    """Write ``spec`` under ``work``, replay it on ``world`` ranks, and
    return every rank's results (rank order)."""
    path = os.path.join(work, "spec.pt")
    torch.save(spec, path)
    launch(run_ranks, world, (backend, device, path, work, threads),
           timeout)
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def assert_ranks_equal(results) -> None:
    """Every rank's losses and recorded states bitwise equal rank 0's."""
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
def tiny_spec(world: int, num_events=256, num_nodes=32, dn=16, de=8,
              seed=0) -> dict:
    """The JAX dry run's tiny stream (``__graft_entry__._tiny_setup``),
    batch 4 a rank, 4 neighbours, two steps of each run: the training form
    (dropout 0.1, bf16) and the deterministic form (dropout 0, float32)."""
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
    b = 4 * world
    r = np.random.RandomState(2)
    batches = [loops.Batch(
        src=torch.from_numpy(r.randint(1, num_nodes, b).astype(np.int32)),
        dst=torch.from_numpy(r.randint(1, num_nodes, b).astype(np.int32)),
        ts=torch.full((b,), float(ts.max()) + 1 + k),
        eidx=torch.from_numpy(r.randint(1, num_events, b).astype(np.int32)),
        mask=torch.ones(b, dtype=torch.bool)) for k in range(2)]
    model = dict(node_dim=dn, edge_dim=de, num_nodes=nodes, n_layers=2,
                 n_head=2)
    runs = [make_run(dict(model, dropout=0.1), batches),
            make_run(dict(model, dropout=0.0, compute_dtype=torch.float32),
                     batches, record=(1, 2))]
    return make_spec(ev, nodes, edges, node, edge, np.unique(dst), 4, runs)


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
    print(f"mesh: dp={w} sp=1 tp=1 over {w} ranks ({backend}, {dev.type}; "
          f"the JAX dry run's factorize({w}) = {M.factorize(w)}: sp and tp "
          f"wait for ROADMAP.md A16's design)")
    spec = tiny_spec(w)
    with tempfile.TemporaryDirectory(prefix="dryrun_") as work:
        results = run_spec(spec, w, backend, args.device, work)
    assert_ranks_equal(results)
    loss = results[0][0]["loss"][0]
    assert np.isfinite(loss), loss
    print(f"dryrun_multichip({w}) ok: tgn loss={loss:.4f}")
    plain = replay_plain(dict(spec, runs=spec["runs"][1:]), dev)[0]
    got = results[0][1]
    for k in (1, 2):
        assert abs(got["loss"][k - 1] - plain["loss"][k - 1]) < 1e-5, (
            got["loss"], plain["loss"])
        for name, a in plain["states"][k]["memory"].items():
            b = got["states"][k]["memory"][name]
            if a.dtype == torch.bool:
                assert torch.equal(a, b), f"memory {name} after step {k}"
            else:
                torch.testing.assert_close(
                    b, a, rtol=1e-5, atol=1e-5,
                    msg=f"sharded-vs-1-process memory {name} after step {k}")
    print(f"dryrun_multichip({w}) ok: deterministic memory/loss parity vs "
          f"1-device at 1e-5")
    print(f"dryrun_multichip({w}): the {', '.join(NOT_PORTED)} checks are "
          f"not ported yet (ROADMAP.md A16b)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
