"""Per-stage cost breakdown of the TGN train step.

Port of ``tempme_tpu/tools/profile_step.py``. It times each stage of the
step by itself, on the same model as the JAX tool (2 layers, 2 heads,
dropout 0.1, batch 256, 30 neighbours, the graph of the train split):

  * sample     -- the negatives and the three 2-hop supports
                  (``loops.sample_support``: 6 ``sample_rows`` launches)
  * fwd        -- memory advance + attention pyramid + affinity, eval form
  * fwd_drop   -- the same with dropout (the training form,
                  ``attend_drop``)
  * embed      -- the embeddings alone, no memory write-back
  * memory     -- the embeddings and the memory write-back
  * fwdbwd     -- the loss's gradient for every parameter, each consumed
  * full       -- the driver's train step (sampling + fwd/bwd + Adam)
  * sample_hop0, sample_hop1 -- one side's hop-0 and hop-1 sampling

The draws (negatives' indices, support uniforms, dropout uniforms) are
made once beforehand, as the port's steps take them injected. Stages do
not sum exactly to the full step, but they bound where the time goes.

On the CUDA card each stage's ``*_ms`` is device time and ``*_host_ms``
the time of eager calls between CUDA events, which includes the host's
launch time. The sampling stages and ``embed`` are captured in a CUDA
graph (``utils/profiling.py::time_ms``: device time from the graph's
replays, timed with CUDA events). The stages that write the memory
(``fwd``, ``fwd_drop``, ``memory``, ``fwdbwd`` and ``full``) cannot be
captured: the memory write-back copies a host scalar to the card
(``TGN._persist_positives``), and Adam's step reads its host-side step
count. For them ``*_ms`` is the device-busy time that ``torch.profiler``
sees (``busy_ms``) and ``*_host_ms`` is ``eager_ms``.
``events_per_s_full`` is the batch over ``full_host_ms``, the step as a
user runs it. ``clock`` names each stage's timer. On the CPU
(``device="cpu"``) every stage is timed on the host clock (``host_ms``)
and has no ``*_host_ms`` twin. ``launches`` counts each stage's kernel
launches in one call (0 on the CPU, which runs the plain versions).

    python -m tempme_tpu_torch.tools.profile_step --data wikipedia \
        --data_dir processed [--trace DIR] [--bs 256]

``--trace DIR`` traces five full steps with ``torch.profiler`` into DIR (a
Chrome trace; ``tools/op_census.py --trace`` reads it). Prints one JSON
line with the JAX tool's keys; ``cli profile`` runs it.
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from ..data.events import RandEdgeSampler, load_dataset
from ..data.graph import build_temporal_graph
from ..models.common import Features
from ..models.tgn import TGN, init_memory_state
from ..ops import sampler as S
from ..ops.kernels.attend import attend, attend_bwd, attend_drop
from ..ops.kernels.sample_rows import sample_rows
from ..train import loops
from ..train.learn_tgn import make_tgn_train_step
from ..utils import profiling
from ..utils.devices import resolve_device

KERNELS = {"sample_rows": sample_rows, "attend": attend,
           "attend_drop": attend_drop, "attend_bwd": attend_bwd}


def tgn_train_setup(train, num_nodes: int, num_edges: int, node_feat,
                    edge_feat, n_degree: int, dev, dropout: float = 0.1,
                    seed: int = 0):
    """The TGN train step over ``train``'s graph at 2 layers and 2 heads
    (fresh weights from ``seed``, Adam lr 1e-3), its memory and a generator
    for its draws: ``(step, mem, generator)``."""
    g = build_temporal_graph(train, num_nodes, num_edges, device=dev)
    feats = Features(torch.from_numpy(node_feat).to(dev),
                     torch.from_numpy(edge_feat).to(dev))
    model = TGN(node_dim=node_feat.shape[1], edge_dim=edge_feat.shape[1],
                num_nodes=num_nodes, n_layers=2, n_head=2, dropout=dropout,
                device=dev, seed=seed)
    mem = init_memory_state(num_nodes, model.memory_dim,
                            model.raw_message_dim, device=dev)
    dst = RandEdgeSampler([train.src], [train.dst]).dst_list
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = make_tgn_train_step(model, g, feats, torch.from_numpy(dst).to(dev),
                               n_degree, optimizer)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    return step, mem, generator


def count_launches(fn) -> dict:
    """The port's kernel launches in one call of ``fn``."""
    for f in KERNELS.values():
        f.launches = 0
    fn()
    return {name: f.launches for name, f in KERNELS.items()}


def stages(step, mem, batch, draws) -> dict:
    """``{name: zero-argument callable}``, one per stage, on fixed inputs."""
    m, g, feats, n = step.model, step.g, step.feats, step.n
    sup = draws.support
    bgd, s0, s1, s2 = loops.sample_support(g, batch, step.dst_table, 2, n,
                                           sup, use_eidx=False)
    args = (feats, mem, batch.src, batch.dst, bgd, batch.ts, batch.eidx,
            s0, s1, s2)
    params = [p for p in m.parameters() if p.requires_grad]
    ones = torch.ones(batch.src.shape[0], device=batch.src.device)

    def sample():
        return loops.sample_support(g, batch, step.dst_table, 2, n, sup,
                                    use_eidx=False)

    @torch.no_grad()
    def fwd():
        (pos, neg), new_mem = m.contrast(*args)
        return pos.sum() + neg.sum(), new_mem

    @torch.no_grad()
    def fwd_drop():
        (pos, neg), _ = m.contrast(*args, drop=draws.dropout)
        return pos.sum() + neg.sum()

    @torch.no_grad()
    def embed():
        (s, t, b), _ = m.get_node_emb(*args, update_memory=False)
        return s.sum() + t.sum() + b.sum()

    @torch.no_grad()
    def memory():
        _, new_mem = m.get_node_emb(*args, update_memory=True)
        return new_mem.msg_buf.sum()

    def fwdbwd():
        (pos, neg), _ = m.contrast(*args)
        loss = (loops.masked_bce_with_logits(pos, ones, batch.mask)
                + loops.masked_bce_with_logits(neg, ones * 0, batch.mask))
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        # consume every gradient, as the JAX tool does
        return loss.detach(), sum(x.square().sum() for x in grads
                                  if x is not None)

    def full():
        return step(mem, batch, draws)

    hop0 = S.sample_neighbors(g, sup.u_src[0], batch.src, batch.ts, n)

    def sample_hop0():
        return S.sample_neighbors(g, sup.u_src[0], batch.src, batch.ts, n)

    def sample_hop1():
        nn_, ne, nt = hop0
        return S.sample_neighbors(g, sup.u_src[1], nn_.reshape(-1),
                                  nt.reshape(-1), n, eids=ne.reshape(-1))

    return {"sample": sample, "fwd": fwd, "fwd_drop": fwd_drop,
            "embed": embed, "memory": memory, "fwdbwd": fwdbwd,
            "full": full, "sample_hop0": sample_hop0,
            "sample_hop1": sample_hop1}


# the stages a CUDA graph can hold; the others write the memory
GRAPH = ("sample", "embed", "sample_hop0", "sample_hop1")


def main(argv=None, device=None):
    """Time every stage; prints and returns one dict (the JAX tool's keys,
    plus ``*_host_ms``, ``clock``, ``launches`` and ``device``). Runs on
    the CUDA card unless ``device="cpu"``."""
    ap = argparse.ArgumentParser("tempme_tpu_torch per-stage step profile")
    ap.add_argument("-d", "--data", default="uslegis_sampled")
    ap.add_argument("--data_dir",
                    default=os.environ.get("TEMPME_DATA_DIR", "processed"))
    ap.add_argument("--bs", type=int, default=256)
    ap.add_argument("--n_degree", type=int, default=30)
    ap.add_argument("--trace", default=None,
                    help="directory for a torch.profiler trace of five full "
                         "steps")
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    ds = load_dataset(args.data, args.data_dir)
    bs, n = args.bs, args.n_degree
    step, mem, gen = tgn_train_setup(ds.train, ds.full.num_nodes,
                                     ds.full.num_edges, ds.node_feat,
                                     ds.edge_feat, n, dev)
    batch = loops.Batch(*(x[0] for x in loops.stack_batches(
        ds.train, bs, shuffle=True, seed=0, device=dev)))
    draws = step.draw(gen, bs)
    fns = stages(step, mem, batch, draws)

    times, clock, launches = {}, {}, {}
    for name, fn in fns.items():
        launches[name] = count_launches(fn)
        if dev.type != "cuda":
            times[f"{name}_ms"] = profiling.host_ms(fn)
            clock[name] = "host"
        elif name in GRAPH:
            times[f"{name}_ms"], times[f"{name}_host_ms"] = \
                profiling.time_ms(fn)
            clock[name] = "cuda graph replay"
        else:
            times[f"{name}_ms"] = profiling.busy_ms(fn)
            times[f"{name}_host_ms"] = profiling.eager_ms(fn)
            clock[name] = "profiler device busy"
    full = times.get("full_host_ms", times["full_ms"])
    times["events_per_s_full"] = bs / (full / 1e3)

    if args.trace:
        with profiling.trace(args.trace):
            for _ in range(5):
                out = fns["full"]()
            out[1]["loss"].item()
        times["trace_dir"] = args.trace
        times["trace"] = profiling.latest_trace(args.trace)

    times.update(bs=bs, n_degree=n, backend=dev.type, clock=clock,
                 launches=launches,
                 device=torch.cuda.get_device_name(dev)
                 if dev.type == "cuda" else "cpu")
    print(json.dumps(times))
    return times


if __name__ == "__main__":
    main()
