#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA card. The
script

1. prints the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. builds the CUDA kernels from ``tempme_tpu_torch/ops/kernels/csrc`` with
   plain ``nvcc`` (all sources at once) and prints the build time;
3. holds each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it, plus edge probes, and times the kernel,
   the plain version and, where one exists, one PyTorch library call that
   computes the same function (a yardstick the port never calls);
4. serves TGN link prediction on a wikipedia-shaped stream (9,228 nodes,
   157,474 events, 172-dim features) at the full width of the repo's TGN,
   with seeded random weights: train -> val -> test through
   ``evaluate_tgn`` at batch 256 and 20 neighbours, the memory carried in
   time order, then checks that both kernels ran 6 times per step and that
   the card's results agree with the plain path on the CPU for two steps;
5. prints one JSON line of kernel numbers, the card again, and the last line
   ``{"ok": true, "device": {...}}``.

Any failure raises, and the script exits non-zero. It also exits non-zero,
printing no result, without a CUDA device or outside a checkout.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH, N_DEGREE, SEED = 256, 20, 0
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


def profile_steps(ds, step, mem, dev, n_steps=20):
    """Trace ``n_steps`` test batches with ``torch.profiler``: the device's
    busy share of the window and the kernels that took the most device
    time. The launches made here are not the serving run's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from tempme_tpu_torch.train import loops
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 9)
    batches = loops.iter_batches(ds.test, BATCH, True, dev)
    work = [(next(batches), step.draw(gen, BATCH)) for _ in range(n_steps)]
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch, draws in work:
            _, _, mem = step.step(mem, batch, draws)
        sync(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, count = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
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
    for name, us in sorted(by_name.items(), key=lambda x: -x[1])[:10]:
        say(f"    {us / n_steps:9.1f} us/step {count[name] / n_steps:5.1f}x "
            f"{name[:90]}")


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

    say("[serve] train -> val -> test, memory carried in time order, "
        f"batch {BATCH}, {N_DEGREE} neighbours")
    sample_rows.launches = 0
    attend.launches = 0
    results, mem, wall = serve(ds, step, dev)
    launches = {"sample_rows": sample_rows.launches,
                "attend": attend.launches}
    events = len(ds.train) + len(ds.val) + len(ds.test)
    say(f"  {step.steps} steps, {events} events in {wall:.3f} s: "
        f"{wall / step.steps * 1e3:.3f} ms/step, {events / wall:.1f} events/s")
    for split, r in results.items():
        say(f"  {split}: AP {r['ap']:.6f}, AUC {r['auc']:.6f}, "
            f"acc {r['acc']:.6f}")
    say(f"  launches on the serving path: {launches}")
    if not bool(step.finite):
        raise AssertionError("a logit was not finite")
    if not all(bool(torch.isfinite(x).all()) for x in mem
               if x.dtype != torch.bool):
        raise AssertionError("the memory is not finite")
    for split, r in results.items():
        if not 0.0 <= r["ap"] <= 1.0:
            raise AssertionError(f"{split} AP {r['ap']} outside [0, 1]")
    for name, count in launches.items():
        if count != 6 * step.steps:
            raise AssertionError(f"{name}: {count} launches for "
                                 f"{step.steps} steps (want 6 per step)")

    say("[trace] torch.profiler over 20 test steps (not counted above)")
    profile_steps(ds, step, mem, dev)

    say("[reference] two test steps on the card against the plain path on "
        "the CPU (rtol 2e-4, atol 1e-5)")
    check_against_cpu(ds, step, mem, dev)
    say("  logits and memory agree")

    kernels = []
    for name, src, replaces, rows, err in (
            ("sample_rows", "tempme_tpu_torch/ops/kernels/csrc/sample_rows.cu",
             "tempme_tpu/ops/pallas/sample_kernel.py:126",
             sr_rows["hop1 Q=5120"], sr_err),
            ("attend", "tempme_tpu_torch/ops/kernels/csrc/attend.cu",
             "tempme_tpu/ops/pallas/kernels.py:110",
             at_rows["hop R=10240"], at_err)):
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
