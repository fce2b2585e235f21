#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA card. The
script

1. prints the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. builds the CUDA kernels from ``tempme_tpu_torch/ops/kernels/csrc`` with
   plain ``nvcc`` (all sources at once) and prints the build time;
3. holds each kernel against its plain PyTorch version on the card at the
   shapes the serving and training paths give it, plus edge probes, and
   times the kernel, the plain version and, where one exists, one PyTorch
   library call that computes the same function (a yardstick the port
   never calls);
4. serves TGN link prediction on a wikipedia-shaped stream (9,228 nodes,
   157,474 events, 172-dim features) at the full width of the repo's TGN,
   with seeded random weights: train -> val -> test through
   ``evaluate_tgn`` at batch 256 and 20 neighbours, the memory carried in
   time order, then checks that both serving kernels ran 6 times per step,
   traces 20 steps and holds two steps against the plain path on the CPU;
5. trains the same TGN for one epoch through the entry point a user calls,
   ``learn_base.main`` on the stream written in the ``ml_{name}`` layout
   (356 steps at batch 256, dropout 0.1, then val and test), and checks the
   loss, the APs, the checkpoints and 6 launches per step of each training
   kernel; stops a second run at a mid-epoch checkpoint and resumes it;
   holds one train step on the card against the same step on the CPU (same
   weights, Adam state, memory and draws); traces 20 train steps;
6. prints one JSON line of kernel numbers, the card again, and the last line
   ``{"ok": true, "device": {...}}``.

Any failure raises, and the script exits non-zero. It also exits non-zero,
printing no result, without a CUDA device or outside a checkout.
"""
import contextlib
import copy
import glob
import io
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH, N_DEGREE, SEED = 256, 20, 0
DROPOUT, LR = 0.1, 1e-3
REF_BATCH = 64                      # the card-vs-CPU train step's batch
H100_BYTES_PER_S = 3.35e12          # published HBM3 rate of the H100 SXM
H100_F32_OPS_PER_S = 67e12          # float32 outside the tensor cores; also
                                    # taken for the kernels' 32-bit int work


def say(msg):
    print(msg, flush=True)


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def time_ms(fn, reps=20, repeats=7):
    """(device ms, host ms) per call of ``fn``. Device: ``reps`` calls
    captured in one CUDA graph, replayed ``repeats`` times, timed with CUDA
    events, median per call; the host's launch overhead is not in it. Host:
    median of single eager calls timed with CUDA events, which includes the
    time the card waits for Python to launch the work."""
    import torch
    side = torch.cuda.Stream()              # warm up off the default stream,
    side.wait_stream(torch.cuda.current_stream())   # as capture wants
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()

    def timed(call, per):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / per

    device = sorted(timed(graph.replay, reps) for _ in range(repeats))
    host = sorted(timed(fn, 1) for _ in range(reps))
    del graph
    return device[len(device) // 2], host[len(host) // 2]


def sample_rows_bytes(g, nodes, times, u, eids):
    """Bytes one sample_rows call must move for these inputs: per query its
    id and cut (time, or edge id and edge time), two offsets and the bisect
    probes (about log2(degree + 1) timestamps), the n draws, 3n table reads
    where the cut is not empty, and 3n outputs."""
    import torch
    q, n = u.shape
    v = nodes.long()
    deg = (g.off[v + 1] - g.off[v]).double()
    probes = torch.ceil(torch.log2(deg + 1)).sum().item()
    per_query = 4 + 4 + 8 + (4 if eids is not None else 0)
    from tempme_tpu_torch.ops.kernels.sample_rows import cut_by_edge, cut_by_time
    if eids is None:
        _, cut = cut_by_time(g, nodes, times)
    else:
        _, cut = cut_by_edge(g, nodes, eids)
    nonempty = (cut > 0).sum().item()
    return q * per_query + 4 * probes + q * n * 4 + nonempty * n * 12 \
        + q * n * 12


def bound(nbytes, ops):
    """(least ms, what bounds it): bytes over the memory rate or operations
    over the peak rate, whichever takes longer."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_sample_rows(g, torch, dev):
    """Bitwise check and times at the serving shapes: Q = 256 (hop 0,
    time cut) and Q = 5,120 (hop 1, edge cut from hop 0's picks)."""
    from tempme_tpu_torch.ops.kernels.sample_rows import (sample_rows,
                                                          sample_rows_plain)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    q0 = BATCH
    nodes0 = torch.randint(1, g.num_nodes, (q0,), generator=gen, device=dev,
                           dtype=torch.int32)
    times0 = torch.rand((q0,), generator=gen, device=dev) * 1e6
    nodes0[:4] = 0                       # probes: node 0, t = 0, no history
    times0[4:8] = 0.0
    u0 = torch.rand((q0, N_DEGREE), generator=gen, device=dev)
    hop0 = sample_rows(g, nodes0, times0, u0)
    ref0 = sample_rows_plain(g, nodes0, times0, u0)
    q1 = q0 * N_DEGREE
    nodes1 = hop0[0].reshape(-1).clone()
    eids1 = hop0[1].reshape(-1).clone()
    eids1[-N_DEGREE:] = 0                # probe: edge 0 forces an empty row
    times1 = hop0[2].reshape(-1).clone()
    u1 = torch.rand((q1, N_DEGREE), generator=gen, device=dev)
    hop1 = sample_rows(g, nodes1, times1, u1, eids1)
    ref1 = sample_rows_plain(g, nodes1, times1, u1, eids1)
    torch.cuda.synchronize()
    err = max((a.double() - b.double()).abs().max().item()
              for a, b in zip(hop0 + hop1, ref0 + ref1))
    if err != 0.0 or not all(torch.equal(a, b)
                             for a, b in zip(hop0 + hop1, ref0 + ref1)):
        raise AssertionError("sample_rows differs from its plain version")
    for out in hop0:
        if out[:8].any():
            raise AssertionError("sample_rows: probe rows are not empty")
    if hop1[0][-N_DEGREE:].any():
        raise AssertionError("sample_rows: edge-0 rows are not empty")
    if not (hop1[0] > 0).any():
        raise AssertionError("sample_rows: hop 1 sampled nothing")
    rows = {}
    for name, args in (("hop0 Q=256", (nodes0, times0, u0, None)),
                       ("hop1 Q=5120", (nodes1, times1, u1, eids1))):
        ms, host = time_ms(lambda: sample_rows(g, *args))
        plain, plain_host = time_ms(lambda: sample_rows_plain(g, *args))
        q, n = args[2].shape
        # ops: n picks, each ranked against the n picks (2 compares)
        least, by = bound(sample_rows_bytes(g, *args), q * n * (2 * n + 4))
        rows[name] = dict(ms=ms, plain_ms=plain, bound_ms=least, bound_by=by)
        say(f"  sample_rows {name}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"bound {least:.5f} ms ({by}), bitwise equal; eager calls "
            f"from the host {host:.4f} / {plain_host:.4f} ms")
    return rows, err


def attend_bytes(m, h, n, dk, with_mask, with_ew):
    """q, k, v, mask, ew read once; out and attn written once."""
    return 4 * (m * h * dk * 2 + 2 * m * n * h * dk + m * h * n) \
        + (m * n if with_mask else 0) + (4 * m * n if with_ew else 0)


def check_attend(torch, dev):
    """allclose check and times at the serving shapes: R = 10,240 rows
    (hop level: 5,120 queries x 2 heads) and R = 512 (root)."""
    import torch.nn.functional as F
    from tempme_tpu_torch.ops.kernels.attend import attend, attend_plain
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    h, n, dk = 2, N_DEGREE, 172
    scale = 1.0 / dk ** 0.5
    rows, worst = {}, 0.0
    for name, m in (("hop R=10240", BATCH * N_DEGREE), ("root R=512", BATCH)):
        q = torch.randn((m, h, dk), generator=gen, device=dev)
        k = torch.randn((m, n, h, dk), generator=gen, device=dev)
        v = torch.randn((m, n, h, dk), generator=gen, device=dev)
        mask = torch.rand((m, n), generator=gen, device=dev) < 0.3
        mask[:3] = True                  # probes: every key masked
        ew = torch.rand((m, n), generator=gen, device=dev)
        for mk, w in ((None, None), (mask, ew), (mask, None)):
            out, attn = attend(q, k, v, mk, w, scale)
            ref_out, ref_attn = attend_plain(q, k, v, mk, w, scale)
            torch.cuda.synchronize()
            torch.testing.assert_close(out, ref_out, rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(attn, ref_attn, rtol=1e-5, atol=1e-6)
            worst = max(worst, (out - ref_out).abs().max().item(),
                        (attn - ref_attn).abs().max().item())
        # the last run had the mask and no explain weight
        expect = torch.full((h, n), 1.0 / n, device=dev)
        if not torch.allclose(attn[0], expect):
            raise AssertionError("attend: an all-masked row is not uniform")
        ms, host = time_ms(lambda: attend(q, k, v, mask, ew, scale))
        plain, plain_host = time_ms(
            lambda: attend_plain(q, k, v, mask, ew, scale))
        # yardstick: one SDPA call, explain weight 1, additive mask; k and v
        # are handed over as head-major views of the same storage
        qs, ks, vs = (q[:, :, None, :], k.permute(0, 2, 1, 3),
                      v.permute(0, 2, 1, 3))
        bias = torch.zeros((m, 1, 1, n), device=dev).masked_fill(
            mask[:, None, None, :], -1e10)
        lib, lib_host = time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=bias))
        # ops: two dk-long multiply-adds per key (score, value), softmax
        least, by = bound(attend_bytes(m, h, n, dk, True, True),
                          m * h * n * (4 * dk + 5))
        rows[name] = dict(ms=ms, plain_ms=plain, bound_ms=least, bound_by=by,
                          library_ms=lib)
        say(f"  attend {name}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"sdpa {lib:.4f} ms, bound {least:.5f} ms ({by}); eager calls "
            f"from the host {host:.4f} / {plain_host:.4f} / {lib_host:.4f} ms")
    say(f"  attend max abs err vs plain {worst:.3e} (rtol 1e-5, atol 1e-6)")
    return rows, worst


class CountingStep:
    """Wraps the eval step: counts steps and keeps a device-side flag that
    every logit was finite (no host sync per step)."""

    def __init__(self, step):
        import torch
        self.step, self.g, self.draw = step, step.g, step.draw
        self.steps = 0
        self.finite = torch.ones((), dtype=torch.bool, device=step.g.device)

    def __call__(self, mem, batch, draws):
        import torch
        pos, neg, mem = self.step(mem, batch, draws)
        self.finite &= torch.isfinite(pos).all() & torch.isfinite(neg).all()
        self.steps += 1
        return pos, neg, mem


def sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def set_up(dev, shape="wikipedia"):
    """The stream, its chronological split, the graph, the TGN at full
    width with seeded weights, and the eval step, on ``dev``."""
    import torch
    from tempme_tpu_torch.data.events import RandEdgeSampler, split_events
    from tempme_tpu_torch.data.graph import build_temporal_graph
    from tempme_tpu_torch.data.synthetic import make_large_shaped
    from tempme_tpu_torch.models.common import Features
    from tempme_tpu_torch.models.tgn import TGN
    from tempme_tpu_torch.train import learn_tgn as T

    ev, node_feat, edge_feat = make_large_shaped(shape)
    ds = split_events(ev, node_feat=node_feat, edge_feat=edge_feat)
    g = build_temporal_graph(ds.full, ds.full.num_nodes, ds.full.num_edges,
                             device=dev)
    feats = Features(torch.from_numpy(ds.node_feat).to(dev),
                     torch.from_numpy(ds.edge_feat).to(dev))
    model = TGN(node_dim=ds.node_feat.shape[1],
                edge_dim=ds.edge_feat.shape[1], num_nodes=ds.full.num_nodes,
                n_layers=2, n_head=2, seed=SEED, device=dev)
    dst_table = torch.from_numpy(RandEdgeSampler(
        [ds.train.src, ds.val.src, ds.test.src],
        [ds.train.dst, ds.val.dst, ds.test.dst]).dst_list).to(dev)
    return ds, g, T.make_tgn_eval_step(model, g, feats, dst_table, N_DEGREE)


def serve(ds, step, dev):
    """train -> val -> test through ``evaluate_tgn`` with the memory carried
    in time order. Returns (metrics per split, final memory, seconds)."""
    from tempme_tpu_torch.models.tgn import init_memory_state
    from tempme_tpu_torch.train import learn_tgn as T
    m = step.step.model
    mem = init_memory_state(m.num_nodes, m.memory_dim, m.raw_message_dim,
                            device=dev)
    sync(dev)
    t0 = time.perf_counter()
    results = {}
    for i, split in enumerate(("train", "val", "test")):
        results[split], mem = T.evaluate_tgn(
            step, mem, getattr(ds, split), BATCH, seed=SEED + i)
    sync(dev)
    return results, mem, time.perf_counter() - t0


def to_device(x, dev):
    if x is None:
        return None
    if isinstance(x, tuple):
        return type(x)(*(to_device(y, dev) for y in x)) \
            if hasattr(x, "_fields") else tuple(to_device(y, dev) for y in x)
    return x.to(dev)


def check_against_cpu(ds, step, mem, dev, n_steps=2):
    """Run ``n_steps`` test batches through the served model on ``dev`` and
    through a CPU copy (plain versions of the kernels) with the same draws
    and memory; logits and memory must agree (rtol 2e-4, atol 1e-5: float32
    sums in another order)."""
    import torch
    from tempme_tpu_torch.data.graph import build_temporal_graph
    from tempme_tpu_torch.models.tgn import TGN
    from tempme_tpu_torch.train import learn_tgn as T
    from tempme_tpu_torch.train import loops
    cpu = torch.device("cpu")
    s = step.step
    model_cpu = TGN(node_dim=s.model.node_dim, edge_dim=s.model.edge_dim,
                    num_nodes=s.model.num_nodes, n_layers=2, n_head=2,
                    seed=SEED, device=cpu)
    g_cpu = build_temporal_graph(ds.full, ds.full.num_nodes,
                                 ds.full.num_edges, device=cpu)
    step_cpu = T.make_tgn_eval_step(model_cpu, g_cpu,
                                    to_device(s.feats, cpu),
                                    s.dst_table.cpu(), N_DEGREE)
    gen = torch.Generator(device=cpu)
    gen.manual_seed(SEED + 7)
    mem_cpu = to_device(mem, cpu)
    batches = loops.iter_batches(ds.test, BATCH, False, cpu)
    for _ in range(n_steps):
        batch = next(batches)
        draws = step_cpu.draw(gen, BATCH)
        pos_c, neg_c, mem_cpu = step_cpu(mem_cpu, batch, draws)
        pos, neg, mem = s(mem, to_device(batch, dev), to_device(draws, dev))
        for a, b in ((pos, pos_c), (neg, neg_c)) + tuple(zip(mem, mem_cpu)):
            if a.dtype == torch.bool:
                if not torch.equal(a.cpu(), b):
                    raise AssertionError("memory flags differ from the CPU")
            else:
                torch.testing.assert_close(a.cpu(), b, rtol=2e-4, atol=1e-5)


def profile_steps(run, n_steps=20):
    """Trace ``n_steps`` calls of ``run(i)`` with ``torch.profiler``: the
    device's busy share of the window and the kernels that took the most
    device time. The launches made here count for no path."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_steps):
            run(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, count = {}, {}
    for e in prof.events():
        # user annotations (``Optimizer.step#...``) span kernels, not one
        if e.device_type == DeviceType.CUDA and \
                not getattr(e, "is_user_annotation", False):
            us = e.time_range.elapsed_us()
            by_name[e.name] = by_name.get(e.name, 0.0) + us
            count[e.name] = count.get(e.name, 0) + 1
    busy = sum(by_name.values())
    if not by_name:
        say("  the profiler saw no device time")
        return
    say(f"  {n_steps} steps traced: wall {wall_us / n_steps / 1e3:.3f} ms/step,"
        f" device busy {busy / n_steps / 1e3:.3f} ms/step, idle share "
        f"{1 - busy / wall_us:.3f}, {sum(count.values()) / n_steps:.0f} "
        f"kernels/step")
    for name, us in sorted(by_name.items(), key=lambda x: -x[1])[:12]:
        say(f"    {us / n_steps:9.1f} us/step {count[name] / n_steps:5.1f}x "
            f"{name[:90]}")


def profile_serving(ds, step, mem, dev, n_steps=20):
    """20 test batches through the eval step."""
    import torch
    from tempme_tpu_torch.train import loops
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    batches = loops.iter_batches(ds.test, BATCH, True, dev)
    work = [(next(batches), step.draw(gen, BATCH)) for _ in range(n_steps)]
    state = [mem]

    def run(i):
        _, _, state[0] = step.step(state[0], *work[i])
    profile_steps(run, n_steps)


def attend_drop_bytes(m, h, n, dk, with_mask, with_ew):
    """``attend_bytes`` plus the draws u [m, h, n], read once."""
    return attend_bytes(m, h, n, dk, with_mask, with_ew) + 4 * m * h * n


def attend_bwd_bytes(m, h, n, dk, with_mask, with_dattn):
    """q, dout, k, v, u (and mask, dattn) read once; dq, dk, dv written
    once."""
    return 4 * (m * h * dk * 3 + 4 * m * n * h * dk + m * h * n
                + (m * h * n if with_dattn else 0)) \
        + (m * n if with_mask else 0)


def check_attend_train(torch, dev):
    """allclose checks and times of the training-form forward and of the
    backward kernel at the train path's shapes: R = 10,240 rows (hop level)
    and R = 512 (root), rate 0.1 with injected draws; timed in the main
    path's form (mask, no explain weight, no cotangent of attn)."""
    from tempme_tpu_torch.ops.kernels.attend import (
        attend_bwd, attend_bwd_plain, attend_drop, attend_drop_plain)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    h, n, dk = 2, N_DEGREE, 172
    scale = 1.0 / dk ** 0.5
    fwd_rows, bwd_rows, fwd_err, bwd_err = {}, {}, 0.0, 0.0
    for name, m in (("hop R=10240", BATCH * N_DEGREE), ("root R=512", BATCH)):
        q = torch.randn((m, h, dk), generator=gen, device=dev)
        k = torch.randn((m, n, h, dk), generator=gen, device=dev)
        v = torch.randn((m, n, h, dk), generator=gen, device=dev)
        mask = torch.rand((m, n), generator=gen, device=dev) < 0.3
        mask[:3] = True                  # probes: every key masked
        ew = torch.rand((m, n), generator=gen, device=dev)
        u = torch.rand((m, h, n), generator=gen, device=dev)
        dout = torch.randn((m, h, dk), generator=gen, device=dev)
        dattn = torch.randn((m, h, n), generator=gen, device=dev)
        for mk, w in ((None, None), (mask, None), (mask, ew)):
            out, attn = attend_drop(q, k, v, mk, w, u, DROPOUT, scale)
            ref_out, ref_attn = attend_drop_plain(q, k, v, mk, w, u, DROPOUT,
                                                  scale)
            got = attend_bwd(q, k, v, mk, w, u, DROPOUT, scale, dout, dattn)
            want = attend_bwd_plain(q, k, v, mk, w, u, DROPOUT, scale, dout,
                                    dattn)
            torch.cuda.synchronize()
            for a, b in ((out, ref_out), (attn, ref_attn)):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
                fwd_err = max(fwd_err, (a - b).abs().max().item())
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
                bwd_err = max(bwd_err, (a - b).abs().max().item())
        if not (attn == 0).any():
            raise AssertionError("attend_drop: no probability was dropped")
        if got[1][0].any():              # the last run had the mask
            raise AssertionError("attend_bwd: an all-masked row's keys got "
                                 "a gradient")
        ms, host = time_ms(lambda: attend_drop(q, k, v, mask, None, u,
                                               DROPOUT, scale))
        plain, plain_host = time_ms(lambda: attend_drop_plain(
            q, k, v, mask, None, u, DROPOUT, scale))
        least, by = bound(attend_drop_bytes(m, h, n, dk, True, False),
                          m * h * n * (4 * dk + 6))
        fwd_rows[name] = dict(ms=ms, plain_ms=plain, bound_ms=least,
                              bound_by=by, library_ms=None)
        say(f"  attend_drop {name}: kernel {ms:.4f} ms, plain {plain:.4f} "
            f"ms, bound {least:.5f} ms ({by}); eager calls from the host "
            f"{host:.4f} / {plain_host:.4f} ms")
        ms, host = time_ms(lambda: attend_bwd(q, k, v, mask, None, u,
                                              DROPOUT, scale, dout))
        plain, plain_host = time_ms(lambda: attend_bwd_plain(
            q, k, v, mask, None, u, DROPOUT, scale, dout))
        # ops: per key the score, dout . v and dq sums (2 dk each), dk and
        # dv (dk each), and the softmax's backward
        least, by = bound(attend_bwd_bytes(m, h, n, dk, True, False),
                          m * h * n * (8 * dk + 12))
        bwd_rows[name] = dict(ms=ms, plain_ms=plain, bound_ms=least,
                              bound_by=by, library_ms=None)
        say(f"  attend_bwd {name}: kernel {ms:.4f} ms, plain (autograd of "
            f"the plain forward) {plain:.4f} ms, bound {least:.5f} ms ({by});"
            f" eager calls from the host {host:.4f} / {plain_host:.4f} ms")
    say(f"  attend_drop max abs err vs plain {fwd_err:.3e} (rtol 1e-5, "
        f"atol 1e-6); attend_bwd {bwd_err:.3e} (rtol 1e-5, atol 1e-5: its "
        f"sums run over up to n * dk terms)")
    return fwd_rows, bwd_rows, fwd_err, bwd_err


DATA_NAME = "wikishape"


def write_stream(ds_dir):
    """The wikipedia-shaped stream in the ``ml_{name}`` CSV/NPY layout
    that ``load_dataset`` reads."""
    import numpy as np
    from tempme_tpu_torch.data.synthetic import make_large_shaped
    ev, node_feat, edge_feat = make_large_shaped("wikipedia")
    table = np.stack([np.arange(len(ev)), ev.src, ev.dst, ev.ts, ev.label,
                      ev.e_idx], axis=1).astype(np.float64)
    np.savetxt(os.path.join(ds_dir, f"ml_{DATA_NAME}.csv"), table,
               fmt=["%d", "%d", "%d", "%.9g", "%.9g", "%d"], delimiter=",",
               header="index,u,i,ts,label,idx", comments="")
    np.save(os.path.join(ds_dir, f"ml_{DATA_NAME}.npy"), edge_feat)
    np.save(os.path.join(ds_dir, f"ml_{DATA_NAME}_node.npy"), node_feat)


def train_argv(ds_dir, out, *extra):
    return ["--data", DATA_NAME, "--data_dir", ds_dir, "--base_type", "tgn",
            "--bs", str(BATCH), "--n_degree", str(N_DEGREE), "--n_epoch", "1",
            "--drop_out", str(DROPOUT), "--lr", str(LR), "--seed", str(SEED),
            "--out_dir", os.path.join(out, "params"),
            "--log_dir", os.path.join(out, "tb"),
            "--results_dir", os.path.join(out, "results"), *extra]


def read_metrics(out):
    """{tag: [values in step order]} from the driver's metrics.jsonl."""
    (path,) = glob.glob(os.path.join(out, "tb", "*", "metrics.jsonl"))
    tags = {}
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            tags.setdefault(rec["tag"], []).append((rec["step"],
                                                    rec["value"]))
    return {k: [v for _, v in sorted(x)] for k, x in tags.items()}


def check_launches(launches, want):
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want}")


def train(ds, ds_dir, out, torch):
    """One epoch of ``learn_base.main`` at full width on the card, the main
    path of this slice. Returns (launches, steps, numbers)."""
    import math
    from tempme_tpu_torch.ops.kernels.attend import (attend, attend_bwd,
                                                     attend_drop)
    from tempme_tpu_torch.ops.kernels.sample_rows import sample_rows
    from tempme_tpu_torch.train import learn_base
    kernels = {"sample_rows": sample_rows, "attend": attend,
               "attend_drop": attend_drop, "attend_bwd": attend_bwd}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in kernels.values():
        f.launches = 0
    t0 = time.perf_counter()
    test_ap = learn_base.main(train_argv(ds_dir, out))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: f.launches for name, f in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    train_steps = len(ds.train) // BATCH
    eval_steps = math.ceil(len(ds.val) / BATCH) + math.ceil(
        len(ds.test) / BATCH)
    want = {"sample_rows": 6 * (train_steps + eval_steps),
            "attend": 6 * eval_steps, "attend_drop": 6 * train_steps,
            "attend_bwd": 6 * train_steps}
    say(f"  launches on the training path: {launches} for {train_steps} "
        f"train and {eval_steps} eval steps")
    check_launches(launches, want)
    tags = read_metrics(out)
    losses = tags["Train/step_loss"]
    if len(losses) != train_steps or not all(map(math.isfinite, losses)):
        raise AssertionError("a train loss is missing or not finite")
    tenth = max(1, train_steps // 10)
    first, last = (sum(x) / len(x) for x in (losses[:tenth],
                                              losses[-tenth:]))
    eps = tags["Train/events_per_s"][0]
    val_ap, test_ap_logged = tags["Val/ap"][0], tags["Test/ap"][0]
    for name, ap in (("val", val_ap), ("test", test_ap)):
        if not 0.0 <= ap <= 1.0:
            raise AssertionError(f"{name} AP {ap} outside [0, 1]")
    if test_ap != test_ap_logged:
        raise AssertionError("the returned test AP is not the logged one")
    params = os.path.join(out, "params", f"tgn_{DATA_NAME}.pt")
    for path in (params, params + ".json", params + ".train_state",
                 os.path.join(out, "results", f"base_tgn_{DATA_NAME}.json")):
        if not os.path.exists(path):
            raise AssertionError(f"missing {path}")
    with open(params + ".json") as f:
        meta = json.load(f)
    if (meta["node_dim"], meta["n_degree"], meta["drop_out"]) != (
            172, N_DEGREE, DROPOUT):
        raise AssertionError(f"checkpoint meta {meta}")
    numbers = dict(train_ms_per_step=BATCH / eps * 1e3, events_per_s=eps,
                   loss_first_tenth=first, loss_last_tenth=last,
                   val_ap=val_ap, test_ap=test_ap, peak_gib=peak / 2 ** 30,
                   wall_s=wall)
    say(f"  {train_steps} steps: {numbers['train_ms_per_step']:.3f} ms/step, "
        f"{eps:.1f} events/s (the driver's epoch clock); mean loss first "
        f"tenth {first:.6f}, last tenth {last:.6f}; val AP {val_ap:.6f}, "
        f"test AP {test_ap:.6f}; peak device memory {peak / 2 ** 30:.3f} "
        f"GiB; main() {wall:.2f} s with loading and eval")
    if not last < first:
        raise AssertionError("the loss did not fall over the epoch")
    return launches, train_steps, numbers


def resume(ds_dir, out):
    """A run with ``--ckpt_every_steps 100`` stopped right after its first
    mid-epoch checkpoint, then ``--resume``d to the end of the epoch."""
    from tempme_tpu_torch.train import learn_base, learn_tgn

    class Stopped(Exception):
        pass

    save = learn_tgn.save_checkpoint

    def stopping_save(path, blob, meta=None):
        save(path, blob, meta=meta)
        if meta and meta.get("step", -1) >= 0:
            raise Stopped()

    argv = train_argv(ds_dir, out, "--ckpt_every_steps", "100")
    learn_tgn.save_checkpoint = stopping_save
    try:
        learn_base.main(argv)
        raise AssertionError("the run did not stop at its checkpoint")
    except Stopped:
        pass
    finally:
        learn_tgn.save_checkpoint = save
    state = os.path.join(out, "params", f"tgn_{DATA_NAME}.pt.train_state")
    with open(state + ".json") as f:
        meta = json.load(f)
    if (meta["epoch"], meta["step"]) != (0, 100):
        raise AssertionError(f"mid-epoch checkpoint meta {meta}")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        ap = learn_base.main(argv + ["--resume"])
    for line in printed.getvalue().splitlines():
        say(f"    | {line}")
    if "at epoch 0 step 100" not in printed.getvalue():
        raise AssertionError("the second run did not resume at step 100")
    with open(state + ".json") as f:
        meta = json.load(f)
    if meta["epoch"] != 0 or "step" in meta or not 0.0 <= ap <= 1.0:
        raise AssertionError(f"the resumed run did not finish: {meta}")


def train_steps_on(dev, ds, blob):
    """The train step of the trained checkpoint ``blob`` on ``dev``: model,
    Adam state and memory loaded, train graph and features on ``dev``."""
    import torch
    from tempme_tpu_torch.data.events import RandEdgeSampler
    from tempme_tpu_torch.data.graph import build_temporal_graph
    from tempme_tpu_torch.models.common import Features
    from tempme_tpu_torch.models.tgn import TGN, TGNMemoryState
    from tempme_tpu_torch.train import learn_tgn as T
    g = build_temporal_graph(ds.train, ds.full.num_nodes, ds.full.num_edges,
                             device=dev)
    feats = Features(torch.from_numpy(ds.node_feat).to(dev),
                     torch.from_numpy(ds.edge_feat).to(dev))
    model = TGN(ds.node_feat.shape[1], ds.edge_feat.shape[1],
                ds.full.num_nodes, n_layers=2, n_head=2, dropout=DROPOUT,
                device=dev)
    model.load_state_dict(blob["params"])
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    opt.load_state_dict(copy.deepcopy(blob["opt_state"]))  # Adam updates
                                                           # it in place
    dst = RandEdgeSampler([ds.train.src], [ds.train.dst]).dst_list
    step = T.make_tgn_train_step(model, g, feats,
                                 torch.from_numpy(dst).to(dev), N_DEGREE, opt)
    mem = TGNMemoryState(**{k: v.to(dev) for k, v in blob["memory"].items()})
    return step, mem


def check_train_against_cpu(ds, out, dev):
    """One train step at full width (batch 64) on the card and on the CPU
    from the trained checkpoint, with the same draws (dropout 0.1
    included). Returns the card's step and memory for the trace."""
    import numpy as np
    import torch
    from tempme_tpu_torch.train import loops
    from tempme_tpu_torch.utils.checkpoint import load_checkpoint
    blob, _ = load_checkpoint(os.path.join(
        out, "params", f"tgn_{DATA_NAME}.pt.train_state"), map_location="cpu")
    cpu = torch.device("cpu")
    step_c, mem_c = train_steps_on(cpu, ds, blob)
    step_g, mem_g = train_steps_on(dev, ds, blob)
    batch = loops.Batch(*(x[0] for x in loops.stack_batches(
        ds.train, REF_BATCH, True, SEED + 1, cpu)))
    gen = torch.Generator(device=cpu)
    gen.manual_seed(SEED + 3)
    draws = step_c.draw(gen, REF_BATCH)
    new_c, aux_c = step_c(mem_c, batch, draws)
    new_g, aux_g = step_g(mem_g, to_device(batch, dev),
                          to_device(draws, dev))
    torch.cuda.synchronize()
    loss_c, loss_g = aux_c["loss"].item(), aux_g["loss"].item()
    if not abs(loss_g - loss_c) <= 1e-4 * abs(loss_c):
        raise AssertionError(f"loss {loss_g} on the card, {loss_c} on CPU")
    worst_g, worst_p, unsettled = 0.0, 0.0, 0
    params_c = dict(step_c.model.named_parameters())
    for name, p in step_g.model.named_parameters():
        pc = params_c[name]
        g_c, g_g = pc.grad, p.grad.cpu()
        top = g_c.abs().max().item()
        torch.testing.assert_close(g_g, g_c, rtol=1e-3, atol=1e-4 * top,
                                   msg=lambda m: f"{name} grad: {m}")
        worst_g = max(worst_g, (g_g - g_c).abs().max().item() / max(top,
                                                                    1e-30))
        # Adam turns gradients that are round-off (terms that cancel in
        # exact arithmetic) into steps of up to lr; hold the rest tightly
        settled = g_c.abs() >= 1e-4 * top
        unsettled += int((~settled).sum())
        diff = (p.detach().cpu() - pc.detach()).abs()
        if diff.max().item() > LR * 1.001:
            raise AssertionError(f"{name}: params after Adam differ by "
                                 f"{diff.max().item()}")
        torch.testing.assert_close(p.detach().cpu()[settled],
                                   pc.detach()[settled], rtol=1e-5,
                                   atol=1e-6,
                                   msg=lambda m: f"{name} param: {m}")
        worst_p = max(worst_p, diff[settled].max().item()
                      if settled.any() else 0.0)
    for name, a, b in zip(new_c._fields, new_g, new_c):
        if a.dtype == torch.bool:
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"memory {name} differs from the CPU")
        else:
            torch.testing.assert_close(a.cpu(), b, rtol=2e-4, atol=1e-5)
    say(f"  loss {loss_g:.7f} card, {loss_c:.7f} CPU; worst gradient error "
        f"{worst_g:.3e} of its tensor's largest; worst settled param "
        f"error after Adam {worst_p:.3e} ({unsettled} round-off-gradient "
        f"entries held to lr); memory agrees")
    return step_g, new_g


def profile_training(ds, step, mem, dev, n_steps=20):
    """20 train steps at batch 256 from the checkpoint's state."""
    import torch
    from tempme_tpu_torch.train import loops
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 11)
    batches = loops.stack_batches(ds.train, BATCH, True, SEED + 2, dev)
    work = [(loops.Batch(*(x[i] for x in batches)), step.draw(gen, BATCH))
            for i in range(n_steps)]
    state = [mem]

    def run(i):
        state[0], _ = step(state[0], *work[i])
    profile_steps(run, n_steps)


def main():
    if not os.path.isdir(os.path.join(ROOT, "tempme_tpu_torch")):
        print("chip_smoke.py: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from tempme_tpu_torch.ops.kernels import _build
    from tempme_tpu_torch.ops.kernels.attend import attend
    from tempme_tpu_torch.ops.kernels.sample_rows import sample_rows
    from tempme_tpu_torch.utils.devices import resolve_device
    dev = resolve_device(None)

    card = gpu_line()
    say(f"[env] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    reports = _build.build()
    build_s = time.perf_counter() - t0
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas {name}: {line.strip()}")
    say(f"[build] {len(_build.KERNELS)} kernels ready in {build_s:.2f} s "
        f"({len(reports)} compiled by this run)")
    if build_s >= 60:
        raise AssertionError(f"kernel build took {build_s:.1f} s (limit 60)")

    say("[slice set-up]")
    t0 = time.perf_counter()
    ds, g, eval_step = set_up(dev)
    step = CountingStep(eval_step)
    sync(dev)
    model = eval_step.model
    say(f"  wikipedia-shaped stream: {ds.full.num_nodes} nodes, "
        f"{len(ds.full)} events (train {len(ds.train)}, val {len(ds.val)}, "
        f"test {len(ds.test)}), width {model.node_dim}, 2 layers, 2 heads, "
        f"d_k {model.attn_layers[0].attn.d_k}, set-up "
        f"{time.perf_counter() - t0:.2f} s")

    say("[kernels] each kernel against its plain version on the card")
    sr_rows, sr_err = check_sample_rows(g, torch, dev)
    at_rows, at_err = check_attend(torch, dev)
    drop_rows, bwd_rows, drop_err, bwd_err = check_attend_train(torch, dev)

    say("[serve] train -> val -> test, memory carried in time order, "
        f"batch {BATCH}, {N_DEGREE} neighbours")
    sample_rows.launches = 0
    attend.launches = 0
    results, mem, wall = serve(ds, step, dev)
    serve_launches = {"sample_rows": sample_rows.launches,
                      "attend": attend.launches}
    events = len(ds.train) + len(ds.val) + len(ds.test)
    say(f"  {step.steps} steps, {events} events in {wall:.3f} s: "
        f"{wall / step.steps * 1e3:.3f} ms/step, {events / wall:.1f} events/s")
    for split, r in results.items():
        say(f"  {split}: AP {r['ap']:.6f}, AUC {r['auc']:.6f}, "
            f"acc {r['acc']:.6f}")
    say(f"  launches on the serving path: {serve_launches}")
    if not bool(step.finite):
        raise AssertionError("a logit was not finite")
    if not all(bool(torch.isfinite(x).all()) for x in mem
               if x.dtype != torch.bool):
        raise AssertionError("the memory is not finite")
    for split, r in results.items():
        if not 0.0 <= r["ap"] <= 1.0:
            raise AssertionError(f"{split} AP {r['ap']} outside [0, 1]")
    for name, count in serve_launches.items():
        if count != 6 * step.steps:
            raise AssertionError(f"{name}: {count} launches for "
                                 f"{step.steps} steps (want 6 per step)")

    say("[trace] torch.profiler over 20 test steps (not counted above)")
    profile_serving(ds, step, mem, dev)

    say("[reference] two test steps on the card against the plain path on "
        "the CPU (rtol 2e-4, atol 1e-5)")
    check_against_cpu(ds, step, mem, dev)
    say("  logits and memory agree")
    del step, eval_step, g, mem

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        ds_dir = os.path.join(work, "data")
        os.makedirs(ds_dir)
        t0 = time.perf_counter()
        write_stream(ds_dir)
        say(f"[train] learn_base.main on the stream in the ml_{DATA_NAME} "
            f"layout (written in {time.perf_counter() - t0:.2f} s): one "
            f"epoch, batch {BATCH}, {N_DEGREE} neighbours, dropout "
            f"{DROPOUT}, Adam lr {LR}, width 172")
        launches, train_steps, numbers = train(ds, ds_dir,
                                               os.path.join(work, "train"),
                                               torch)
        say("[resume] --ckpt_every_steps 100: stopped after the first "
            "mid-epoch checkpoint, then --resume to the end of the epoch")
        t0 = time.perf_counter()
        resume(ds_dir, os.path.join(work, "resume"))
        say(f"  resumed and finished in {time.perf_counter() - t0:.2f} s "
            f"for both runs")
        say(f"[train-reference] one train step (batch {REF_BATCH}, width "
            f"172, dropout {DROPOUT}) on the card against the CPU from the "
            "trained checkpoint: loss rtol 1e-4; gradients rtol 1e-3, atol "
            "1e-4 of the tensor's largest; params after Adam rtol 1e-5, "
            "atol 1e-6; memory rtol 2e-4, atol 1e-5")
        step_g, mem_g = check_train_against_cpu(
            ds, os.path.join(work, "train"), dev)
    say("[trace-train] torch.profiler over 20 train steps at batch "
        f"{BATCH} (not counted above)")
    profile_training(ds, step_g, mem_g, dev)
    say(f"  training cell: {json.dumps(numbers)}")

    kernels = []
    csrc = "tempme_tpu_torch/ops/kernels/csrc/"
    for name, src, replaces, rows, err in (
            ("sample_rows", csrc + "sample_rows.cu",
             "tempme_tpu/ops/pallas/sample_kernel.py:126",
             sr_rows["hop1 Q=5120"], sr_err),
            ("attend", csrc + "attend.cu",
             "tempme_tpu/ops/pallas/kernels.py:110",
             at_rows["hop R=10240"], at_err),
            ("attend_drop", csrc + "attend.cu",
             "tempme_tpu/ops/pallas/kernels.py:125",
             drop_rows["hop R=10240"], drop_err),
            ("attend_bwd", csrc + "attend_bwd.cu",
             "tempme_tpu/ops/pallas/kernels.py:229,247",
             bwd_rows["hop R=10240"], bwd_err)):
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": rows["ms"],
                        "plain_ms": rows["plain_ms"],
                        "bound_ms": rows["bound_ms"],
                        "bound_by": rows["bound_by"],
                        "library_ms": rows.get("library_ms")})
    say(json.dumps({"kernels": kernels}))
    say(gpu_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
