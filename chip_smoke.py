#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Run from a checkout of the repository on a machine with a CUDA card. The
script

1. prints the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. builds the CUDA kernels from ``tempme_tpu_torch/ops/kernels/csrc`` with
   plain ``nvcc`` (all sources at once) and prints the build time;
3. holds each kernel against its plain PyTorch version on the card at the
   shapes the serving, training and explainer paths give it (the walk
   samplers and ``walk_to_edge`` on inputs captured from the explainer's
   own sampling and forward), plus edge probes, and times the kernel, the
   plain version and, where one exists, one PyTorch library call that
   computes the same function (a yardstick the port never calls);
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
6. trains the same TGN data-parallel (``tempme_tpu_torch/parallel/``)
   from the checkpoint of step 5 at full width: over nccl at world size 1
   in this process, bitwise equal to the plain card step over 3 steps;
   then 2 ranks spawned on this card over gloo with CUDA tensors, 20
   global steps of 256 (128 a rank) at float32, both ranks' states bitwise
   equal, each of the first 3 steps held against the 1-process card step
   from the same state (loss, gradients, Adam state, parameters, memory),
   the state after those 3 steps in a row held against the 1-process card
   run's, within the distance of the same run on the CPU from it (the
   witness of round-off carried over steps), 6 launches a rank a step of
   each training kernel, the step's wall ms and the collectives' ms and
   bytes (the ranks share one card: not a scaling measurement); then
   [sp-tp]: the same step on the sp and tp mesh axes from that checkpoint
   (float32, batch 256; meshes 1x2x1 and 1x1x2 on 2 gloo ranks, 5 steps
   each, and 2x2x1 on 4, 3 steps): every rank's whole state (its shards
   gathered) bitwise equal, the first 3 steps against the 1-process card
   step, the golden's collectives, each rank's memory and message rows
   (``ceil(num_nodes / sp)``, their bytes beside the 1-process state's)
   and its tp shards (``out / tp`` rows, with their Adam moments);
7. trains the TempME explainer for one epoch on the frozen TGN of step 5
   through ``temp_exp_main.main`` over the stream's first 15,000 events
   (``ml_wikishape15k``, the cut of steps 9-13; 85 steps at batch 100,
   20 neighbours, 60 walks a side, then val and test with fidelity and the
   16-ratio sweep), checks its numbers, files and the launches of all seven kernels
   per step; stops a second run at a mid-epoch checkpoint and resumes it;
   runs ``--eval_only`` on the saved explainer; holds one explainer train
   step and one eval step's ratio sweep on the card against the CPU
   (float32, same draws; every card parameter after Adam against Adam
   replayed in float64 with the card's own gradient); traces 20 explainer
   train steps;
8. holds the kernels against their plain versions at the TGAT paths'
   shapes too (3 layers, d_k 258 and the uslegis TGAT's 173, rows up to
   40,000, ``sample_rows`` at hop 3) and at the sizes that once failed to
   launch (``sample_rows`` at n 3,073 and 4,096, ``walk_to_edge`` at 4,097
   and 8,192 slots a row);
9. trains TGAT at ``learn_base.main``'s default flags (3 layers, 2 heads,
   the deep-TGAT batch 32, width 172) for one epoch on the first 15,000
   events of the stream, ``ml_wikishape15k`` (a cut of scale, not of
   width), and checks the loss, the APs, the files and the launches
   per step (each block's forward again in the backward: its blocks are
   checkpointed); resumes the state of a run stopped at a mid-epoch
   checkpoint; holds one TGAT train step on the card against the CPU, and
   the committed uslegis TGAT (read by the port's own msgpack reader) at
   float32 and bf16; trains the explainer one epoch on the TGAT (3-hop
   supports, the sweep in chunks of 4 ratios), resumes it, runs its
   ``--eval_only``; traces 20 TGAT train steps; then [dp-explain]: the
   explainer's data-parallel step (``parallel/``) from the checkpoints of
   steps 7 and 9, over nccl at world size 1 in this process bitwise equal
   to the plain card step (3 TGN-explainer steps, 2 TGAT-explainer steps),
   then the TGN explainer on 2 gloo ranks sharing this card, 10 global
   steps of 100 at float32: both ranks bitwise equal, each of the first 2
   steps held against the 1-process card step from the same state, the
   launches a rank a step of the 1-process step, the collectives by kind
   (the committed golden), the step's wall ms and the collectives' ms and
   bytes;
10. trains GraphMixer at ``learn_base.main``'s default flags (3 mixer
   blocks, 20 neighbours = tokens, width 172, batch 256) for one epoch on
   the 15,000-event cut of step 7, and checks the loss, the APs, the files
   (meta ``n_layer`` 3, the block count) and 6 ``sample_rows`` launches
   per step; resumes the state of a run stopped at a mid-epoch
   checkpoint; runs ``--eval_only`` on that
   GraphMixer and on the TGAT of step 9, each reproducing the test metrics
   its training run wrote exactly, and on the TGN of step 5, which scores
   test from the checkpoint's memory and must equal ``evaluate_tgn`` run
   from that memory, exactly; holds one GraphMixer train step and the
   committed uslegis GraphMixer (3 blocks) on the card against the CPU;
   trains the explainer one epoch on the GraphMixer (hop-0 explanations),
   checks its numbers, files and launches, resumes it, runs its
   ``--eval_only`` and holds one explainer train step and one eval step's
   sweep against the CPU; traces 20 GraphMixer and 20 explainer train
   steps;
11. runs enhance on the same cut for a TGN trained there and the
   GraphMixer of step 10 (2 epochs, the second resumed from the first's
   state), and for the TGAT of step 9, holds one enhance step of each
   against the CPU (the TGAT's also against a CPU float64 step where its
   float32 round-off parts the card from the CPU, C11) and traces the
   TGN's; then [dp-enhance]: enhance's data-parallel step with a fresh
   seeded predictor, over nccl at world size 1 bitwise equal to
   the plain card step (3 steps with that TGN, 2 with the GraphMixer),
   then with the TGN on 2 gloo ranks sharing this card as in [dp-explain];
12. builds the offline walk cache of the TGN's cut through ``python -m
   tempme_tpu_torch.cli preprocess`` (train and test, batch 128, 6
   ``sample_rows``, 3 ``sample_union`` and 3 ``sample_masked`` launches a
   batch; the kernels are also held against their plain versions at these
   shapes in step 3), checks the files, the ids, the classes, the
   negatives, and one batch built on the card against the CPU; trains the
   explainer one epoch from it (``cli explain --use_cache``) on the TGN
   of step 11 with no sampling launch on its train steps, reuses the
   files in a second call, and holds one cached train step against the
   CPU;
13. runs ``cli pipeline`` (learn-base -> explain -> enhance) for a
   GraphMixer on the cut, one epoch a stage, in a scratch working
   directory, and ``cli validate``;
14. trains every base variant that the training flags accept on the first
   5,000 events (``ml_wikishape5k``, the node table trimmed; width 172):
   a TGN (batch 256) (a) ``--memory_updater rnn --aggregator mean
   --message_function identity``, (b) ``--embedding_module identity``,
   (c) ``--embedding_module time``, and a TGAT at its defaults (3 layers,
   batch 32) (a) ``--attn_mode map``, (b) ``--agg_method lstm --use_time
   pos``, (c) ``--agg_method mean --use_time empty``, one epoch each,
   checking the losses, APs, the checkpoint's meta and the launches per
   step, then ``--eval_only`` on each; holds one train step of each run
   on the card against the CPU; trains the explainer on TGN (a) and
   enhance on TGN (b), and checks that the explainer refuses TGAT (b)
   (a process that exits non-zero with the reason); holds the sampler's
   exp-decay and binary modes at Q 2,000 on the card against the CPU, bit
   for bit;
15. runs the tools: ``tools/profile_step.py`` on the wikipedia-shaped
   stream (each stage of the TGN train step timed by itself, 6
   ``sample_rows``, ``attend_drop`` and ``attend_bwd`` launches a full
   step, a trace of five steps); ``tools/op_census.py --capture enron``
   (shares that sum to 100%, the port's kernels found by name);
   ``temp_exp_main --profile --n_epoch 2`` on the TGN of step 5 over the
   stream's first 2,000 events (the trace of epoch 1 holds the walk
   kernels); ``cli visualize`` on the explainer of step 7 (the figures,
   and one batch's plotted arrays on the card against the CPU); one
   ``learn_base`` epoch under ``TEMPME_DEBUG=1``; the native host runtime
   built with g++ (``load_csv`` against numpy, the host picks' cuts);
16. prints its run time against its 1,000 s budget (its hard limit is
   1,200 s; on one NVIDIA H100 80GB HBM3 at 700 W the script took
   696.2-929.7 s on three hosts, and moves 1.3-1.7x with the host), one
   JSON line of kernel numbers (each kernel's launches on every path,
   [dp-explain] and [dp-enhance] among them), the card again, and the last
   line ``{"ok": true, "device": {...}}``.

The TGN runs its projections in bf16, its default (as in the JAX package);
the card-against-CPU checks run at float32 with the earlier tolerances,
plus one bf16 serving check with its own looser tolerance.

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
T0 = time.perf_counter()
BATCH, N_DEGREE, SEED = 256, 20, 0
DROPOUT, LR = 0.1, 1e-3
REF_BATCH = 64                      # the card-vs-CPU train step's batch
H100_BYTES_PER_S = 3.35e12          # published HBM3 rate of the H100 SXM
H100_F32_OPS_PER_S = 67e12          # float32 outside the tensor cores (an
                                    # FMA counted as two operations)
H100_INT32_OPS_PER_S = 67e12 / 4    # 32-bit integer compares, selects and
                                    # adds: 64 lanes per SM per clock against
                                    # 128 float32 FMA lanes, each one
                                    # operation, so a quarter of the above


def say(msg):
    """Print ``msg``; a phase's heading (``[name] ...``) after the seconds
    since the start."""
    if msg.startswith("["):
        msg = f"{time.perf_counter() - T0:7.1f} s {msg}"
    print(msg, flush=True)


def gpu_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def time_ms(fn, reps=20, repeats=7):
    """``tempme_tpu_torch.utils.profiling.time_ms``: (device ms, host ms)
    per call of ``fn``, device time from a CUDA graph's replays."""
    from tempme_tpu_torch.utils import profiling
    return profiling.time_ms(fn, reps, repeats)


def eager_ms(fn, reps=5):
    """``tempme_tpu_torch.utils.profiling.eager_ms``: median ms of single
    eager calls timed with CUDA events."""
    from tempme_tpu_torch.utils import profiling
    return profiling.eager_ms(fn, reps)


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


def bound(nbytes, ops, ops_per_s=H100_F32_OPS_PER_S):
    """(least ms, what bounds it): bytes over the memory rate or operations
    over their peak rate (float32 unless given), whichever takes longer."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_sample_rows(g, torch, dev):
    """Bitwise check and times at the serving shapes, Q = 256 (hop 0,
    time cut) and Q = 5,120 (hop 1, edge cut from hop 0's picks), and at
    the explainer's hop 1, Q = 2,000, and hop 0, Q = 100 (time cut, as the
    negative side's)."""
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
    q2 = 100 * N_DEGREE                  # the explainer's hop 1 (batch 100)
    q3 = EXPLAIN_BATCH                   # the explainer's hop 0
    for name, args in (("hop0 Q=256", (nodes0, times0, u0, None)),
                       ("hop1 Q=5120", (nodes1, times1, u1, eids1)),
                       ("explain hop1 Q=2000", (nodes1[:q2], times1[:q2],
                                                u1[:q2], eids1[:q2])),
                       ("explain hop0 Q=100", (nodes0[:q3], times0[:q3],
                                               u0[:q3], None))):
        ms, host = time_ms(lambda: sample_rows(g, *args))
        plain, plain_host = time_ms(lambda: sample_rows_plain(g, *args))
        q, n = args[2].shape
        # ops: n picks, each ranked against the n picks (2 integer
        # compares)
        least, by = bound(sample_rows_bytes(g, *args), q * n * (2 * n + 4),
                          H100_INT32_OPS_PER_S)
        rows[name] = dict(ms=ms, plain_ms=plain, bound_ms=least, bound_by=by)
        say(f"  sample_rows {name}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"bound {least:.5f} ms ({by}), bitwise equal; eager calls "
            f"from the host {host:.4f} / {plain_host:.4f} ms")
    return rows, err


def attend_bytes(m, h, n, dk, with_mask, with_ew, elem=4):
    """q, k, v (``elem`` bytes each), mask, ew read once; out and attn
    (float32) written once."""
    return elem * (m * h * dk + 2 * m * n * h * dk) \
        + 4 * (m * h * dk + m * h * n) \
        + (m * n if with_mask else 0) + (4 * m * n if with_ew else 0)


# (row name, rows m) of the attention calls: the serving and training
# paths' hop level (batch 256 x 20 queries) and root, and the explainer's
# hop level (batch 100 x 20) and root, which are also the shapes of the
# enhance TGN's training form (``attend_drop``, ``attend_bwd``)
ATTEND_SHAPES = (("hop m=5120", BATCH * N_DEGREE), ("root m=256", BATCH),
                 ("explain hop m=2000", 100 * N_DEGREE),
                 ("explain root m=100", 100))


def check_attend(torch, dev):
    """allclose check and times of the eval form at float32 and bf16 q, k,
    v (the model's default) for ``ATTEND_SHAPES``."""
    import torch.nn.functional as F
    from tempme_tpu_torch.ops.kernels.attend import attend, attend_plain
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    h, n, dk = 2, N_DEGREE, 172
    scale = 1.0 / dk ** 0.5
    rows, worst = {}, 0.0
    for (shape, m), dtype in ((x, d) for x in ATTEND_SHAPES
                              for d in (torch.float32, torch.bfloat16)):
        name = f"{shape} {str(dtype)[6:]}"
        q = torch.randn((m, h, dk), generator=gen, device=dev).to(dtype)
        k = torch.randn((m, n, h, dk), generator=gen, device=dev).to(dtype)
        v = torch.randn((m, n, h, dk), generator=gen, device=dev).to(dtype)
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
        bias = torch.zeros((m, 1, 1, n), device=dev, dtype=dtype).masked_fill(
            mask[:, None, None, :], -1e10)
        lib, lib_host = time_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=bias))
        # ops: two dk-long multiply-adds per key (score, value), softmax
        least, by = bound(attend_bytes(m, h, n, dk, True, True,
                                       q.element_size()),
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


def check_against_cpu(ds, step, mem, dev, compute_dtype, rtol, atol,
                      n_steps=2):
    """Run ``n_steps`` test batches through the TGN of the served one
    (same seeded weights) at ``compute_dtype`` on ``dev`` and through a CPU
    copy (plain versions of the kernels) with the same draws, starting from
    the served memory; logits and memory must agree to ``rtol`` and
    ``atol``."""
    import torch
    from tempme_tpu_torch.data.graph import build_temporal_graph
    from tempme_tpu_torch.models.tgn import TGN
    from tempme_tpu_torch.train import learn_tgn as T
    from tempme_tpu_torch.train import loops
    cpu = torch.device("cpu")
    s = step.step

    def model_on(d):
        return TGN(node_dim=s.model.node_dim, edge_dim=s.model.edge_dim,
                   num_nodes=s.model.num_nodes, n_layers=2, n_head=2,
                   seed=SEED, device=d, compute_dtype=compute_dtype)
    g_cpu = build_temporal_graph(ds.full, ds.full.num_nodes,
                                 ds.full.num_edges, device=cpu)
    step_cpu = T.make_tgn_eval_step(model_on(cpu), g_cpu,
                                    to_device(s.feats, cpu),
                                    s.dst_table.cpu(), N_DEGREE)
    step_dev = T.make_tgn_eval_step(model_on(dev), s.g, s.feats, s.dst_table,
                                    N_DEGREE)
    gen = torch.Generator(device=cpu)
    gen.manual_seed(SEED + 7)
    mem_cpu = to_device(mem, cpu)
    batches = loops.iter_batches(ds.test, BATCH, False, cpu)
    worst = 0.0
    for _ in range(n_steps):
        batch = next(batches)
        draws = step_cpu.draw(gen, BATCH)
        pos_c, neg_c, mem_cpu = step_cpu(mem_cpu, batch, draws)
        pos, neg, mem = step_dev(mem, to_device(batch, dev),
                                 to_device(draws, dev))
        for a, b in ((pos, pos_c), (neg, neg_c)) + tuple(zip(mem, mem_cpu)):
            if a.dtype == torch.bool:
                if not torch.equal(a.cpu(), b):
                    raise AssertionError("memory flags differ from the CPU")
            else:
                torch.testing.assert_close(a.cpu(), b, rtol=rtol, atol=atol)
                worst = max(worst, (a.cpu() - b).abs().max().item())
    return worst


def profile_steps(run, n_steps=20):
    """``tempme_tpu_torch.utils.profiling.profile_steps``, printed through
    ``say``: the device's busy share of ``n_steps`` traced calls of
    ``run(i)`` and the kernels that took the most device time."""
    from tempme_tpu_torch.utils import profiling
    return profiling.profile_steps(run, n_steps, log=say)


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


def attend_drop_bytes(m, h, n, dk, with_mask, with_ew, elem=4):
    """``attend_bytes`` plus the draws u [m, h, n], read once."""
    return attend_bytes(m, h, n, dk, with_mask, with_ew, elem) + 4 * m * h * n


def attend_bwd_bytes(m, h, n, dk, with_mask, with_dattn, elem=4,
                     with_ew=False):
    """q, k, v (``elem`` bytes each), dout, u (and mask, dattn, ew) read
    once; dq, dk, dv (``elem`` bytes) and, with ``with_ew``, dew [m, n]
    written once."""
    return elem * (2 * m * h * dk + 4 * m * n * h * dk) \
        + 4 * (m * h * dk + m * h * n + (m * h * n if with_dattn else 0)) \
        + (m * n if with_mask else 0) + (8 * m * n if with_ew else 0)


def check_attend_train(torch, dev):
    """allclose checks and times of the training-form forward and of the
    backward kernel at float32 and bf16 q, k, v for ``ATTEND_SHAPES``, rate
    0.1 with injected draws; timed in the training path's form (mask, no
    explain weight, no cotangent of attn). The backward with the explain
    weight's gradient (the explainer's form: eval form, mask, weight) is
    timed at the explainer's shape. Returns the rows of the forward, of the
    backward and the errors; bf16 dq, dk, dv are held to rtol 1e-2, atol
    1e-4 (one bf16 rounding of values that differ in their last float32
    digits)."""
    from tempme_tpu_torch.ops.kernels.attend import (
        attend_bwd, attend_bwd_plain, attend_drop, attend_drop_plain)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    h, n, dk = 2, N_DEGREE, 172
    scale = 1.0 / dk ** 0.5
    fwd_rows, bwd_rows, fwd_err, bwd_err = {}, {}, 0.0, 0.0
    for (shape, m), dtype in ((x, d) for x in ATTEND_SHAPES
                              for d in (torch.float32, torch.bfloat16)):
        name = f"{shape} {str(dtype)[6:]}"
        q = torch.randn((m, h, dk), generator=gen, device=dev).to(dtype)
        k = torch.randn((m, n, h, dk), generator=gen, device=dev).to(dtype)
        v = torch.randn((m, n, h, dk), generator=gen, device=dev).to(dtype)
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
            got = attend_bwd(q, k, v, mk, w, u, DROPOUT, scale, dout, dattn,
                             ew_grad=w is not None)
            want = attend_bwd_plain(q, k, v, mk, w, u, DROPOUT, scale, dout,
                                    dattn, ew_grad=w is not None)
            torch.cuda.synchronize()
            for a, b in ((out, ref_out), (attn, ref_attn)):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
                fwd_err = max(fwd_err, (a - b).abs().max().item())
            for a, b in zip(got, want):
                if a is None:
                    continue
                tol = (dict(rtol=1e-2, atol=1e-4) if a.dtype == torch.bfloat16
                       else dict(rtol=1e-5, atol=1e-5))
                torch.testing.assert_close(a.float(), b.float(), **tol)
                if a.dtype == torch.float32:
                    bwd_err = max(bwd_err, (a - b).abs().max().item())
        if not (attn == 0).any():
            raise AssertionError("attend_drop: no probability was dropped")
        if got[1][0].any():              # the last run had the mask
            raise AssertionError("attend_bwd: an all-masked row's keys got "
                                 "a gradient")
        elem = q.element_size()
        ms, host = time_ms(lambda: attend_drop(q, k, v, mask, None, u,
                                               DROPOUT, scale))
        plain, plain_host = time_ms(lambda: attend_drop_plain(
            q, k, v, mask, None, u, DROPOUT, scale))
        least, by = bound(attend_drop_bytes(m, h, n, dk, True, False, elem),
                          m * h * n * (4 * dk + 6))
        fwd_rows[name] = dict(ms=ms, plain_ms=plain, bound_ms=least,
                              bound_by=by, library_ms=None)
        say(f"  attend_drop {name}: kernel {ms:.4f} ms, plain {plain:.4f} "
            f"ms, bound {least:.5f} ms ({by}); eager calls from the host "
            f"{host:.4f} / {plain_host:.4f} ms")
        forms = [("", dict(u=u, rate=DROPOUT, w=None, ew_grad=False))]
        if shape.startswith("explain") and dtype == torch.bfloat16:
            forms.append((" ew", dict(u=None, rate=0.0, w=ew, ew_grad=True)))
        for suffix, f in forms:
            ms, host = time_ms(lambda: attend_bwd(
                q, k, v, mask, f["w"], f["u"], f["rate"], scale, dout,
                ew_grad=f["ew_grad"]))
            plain, plain_host = time_ms(lambda: attend_bwd_plain(
                q, k, v, mask, f["w"], f["u"], f["rate"], scale, dout,
                ew_grad=f["ew_grad"]))
            # ops: per key the score, dout . v and dq sums (2 dk each), dk
            # and dv (dk each), and the softmax's backward
            least, by = bound(
                attend_bwd_bytes(m, h, n, dk, True, False, elem,
                                 f["ew_grad"]),
                m * h * n * (8 * dk + 12))
            bwd_rows[name + suffix] = dict(ms=ms, plain_ms=plain,
                                           bound_ms=least, bound_by=by,
                                           library_ms=None)
            say(f"  attend_bwd {name}{suffix}: kernel {ms:.4f} ms, plain "
                f"(autograd of the plain forward) {plain:.4f} ms, bound "
                f"{least:.5f} ms ({by}); eager calls from the host "
                f"{host:.4f} / {plain_host:.4f} ms")
    say(f"  attend_drop max abs err vs plain {fwd_err:.3e} (rtol 1e-5, "
        f"atol 1e-6); attend_bwd at float32 {bwd_err:.3e} (rtol 1e-5, atol "
        f"1e-5: its sums run over up to n * dk terms; the explain weight's "
        f"gradient too)")
    return fwd_rows, bwd_rows, fwd_err, bwd_err


DATA_NAME = "wikishape"


def write_stream(ds_dir, name=DATA_NAME, num_events=None, trim_nodes=False):
    """The wikipedia-shaped stream (its first ``num_events`` events, all by
    default) in the ``ml_{name}`` CSV/NPY layout that ``load_dataset``
    reads; with ``trim_nodes`` the node table ends at the largest node id
    those events hold (a TGN keeps one memory row per id up to it, as in
    the JAX package, and adds the table to it row for row)."""
    import numpy as np
    from tempme_tpu_torch.data.synthetic import make_large_shaped
    ev, node_feat, edge_feat = make_large_shaped("wikipedia")
    k = num_events or len(ev)
    if trim_nodes:
        node_feat = node_feat[:max(ev.src[:k].max(), ev.dst[:k].max()) + 1]
    table = np.stack([np.arange(k), ev.src[:k], ev.dst[:k], ev.ts[:k],
                      ev.label[:k], ev.e_idx[:k]], axis=1).astype(np.float64)
    np.savetxt(os.path.join(ds_dir, f"ml_{name}.csv"), table,
               fmt=["%d", "%d", "%d", "%.9g", "%.9g", "%d"], delimiter=",",
               header="index,u,i,ts,label,idx", comments="")
    np.save(os.path.join(ds_dir, f"ml_{name}.npy"), edge_feat[:k + 1])
    np.save(os.path.join(ds_dir, f"ml_{name}_node.npy"), node_feat)


def train_argv(ds_dir, out, *extra):
    return ["--data", DATA_NAME, "--data_dir", ds_dir, "--base_type", "tgn",
            "--bs", str(BATCH), "--n_degree", str(N_DEGREE), "--n_epoch", "1",
            "--drop_out", str(DROPOUT), "--lr", str(LR), "--seed", str(SEED),
            "--out_dir", os.path.join(out, "params", "tgnn"),
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
    params = os.path.join(out, "params", "tgnn", f"tgn_{DATA_NAME}.pt")
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
    state = os.path.join(out, "params", "tgnn",
                         f"tgn_{DATA_NAME}.pt.train_state")
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


def train_steps_on(dev, ds, blob, compute_dtype):
    """The train step of the trained checkpoint ``blob`` on ``dev`` with the
    projections in ``compute_dtype``: model, Adam state and memory loaded,
    train graph and features on ``dev``."""
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
                device=dev, compute_dtype=compute_dtype)
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
    from the trained checkpoint at float32, with the same draws (dropout
    0.1 included): the same tolerances as ``compare_train_steps``, the
    memory rtol 2e-4, atol 1e-5 (its flags exactly)."""
    import torch
    from tempme_tpu_torch.train import loops
    from tempme_tpu_torch.utils.checkpoint import load_checkpoint
    blob, _ = load_checkpoint(os.path.join(
        out, "params", "tgnn", f"tgn_{DATA_NAME}.pt.train_state"),
        map_location="cpu")
    cpu = torch.device("cpu")
    step_c, mem_c = train_steps_on(cpu, ds, blob, torch.float32)
    step_g, mem_g = train_steps_on(dev, ds, blob, torch.float32)
    batch = loops.Batch(*(x[0] for x in loops.stack_batches(
        ds.train, REF_BATCH, True, SEED + 1, cpu)))
    gen = torch.Generator(device=cpu)
    gen.manual_seed(SEED + 3)
    draws = step_c.draw(gen, REF_BATCH)
    new_c, aux_c = step_c(mem_c, batch, draws)
    new_g, aux_g = step_g(mem_g, to_device(batch, dev),
                          to_device(draws, dev))
    torch.cuda.synchronize()
    compare_train_steps(step_c, aux_c, step_g, aux_g, "TGN train step")
    for name, a, b in zip(new_c._fields, new_g, new_c):
        if a.dtype == torch.bool:
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"memory {name} differs from the CPU")
        else:
            torch.testing.assert_close(a.cpu(), b, rtol=2e-4, atol=1e-5)
    say("  memory agrees")


def profile_training(ds, out, dev, n_steps=20):
    """20 train steps at batch 256 from the checkpoint's state, the
    projections in bf16 as the driver runs them."""
    import torch
    from tempme_tpu_torch.train import loops
    from tempme_tpu_torch.utils.checkpoint import load_checkpoint
    blob, _ = load_checkpoint(os.path.join(
        out, "params", "tgnn", f"tgn_{DATA_NAME}.pt.train_state"),
        map_location="cpu")
    step, mem = train_steps_on(dev, ds, blob, torch.bfloat16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 11)
    batches = loops.stack_batches(ds.train, BATCH, True, SEED + 2, dev)
    work = [(loops.Batch(*(x[i] for x in batches)), step.draw(gen, BATCH))
            for i in range(n_steps)]
    state = [mem]

    def run(i):
        state[0], _ = step(state[0], *work[i])
    profile_steps(run, n_steps)


DP_STEPS = 20                        # [dp]'s global steps on 2 ranks
DP_CHECKED = 3                       # the steps held against 1 process
DP_PER_STEP = dict(sample_rows=6, attend=0, attend_drop=6, attend_bwd=6)


def dp_spec(ds, blob, steps, **model):
    """A dry-run spec (``parallel/dryrun.py``) of the TGN of [train] at full
    width on the train split: ``steps`` global batches of 256 (shuffled),
    the draws from each rank's generator (made rank 0's by ``place``), the
    checkpoint's parameters, Adam state and memory."""
    import torch
    from tempme_tpu_torch.data.events import RandEdgeSampler
    from tempme_tpu_torch.parallel import dryrun
    from tempme_tpu_torch.train import loops
    batches = loops.stack_batches(ds.train, BATCH, True, SEED + 5, "cpu")
    batches = [loops.Batch(*(x[i] for x in batches)) for i in range(steps)]
    kwargs = dict(node_dim=ds.node_feat.shape[1],
                  edge_dim=ds.edge_feat.shape[1],
                  num_nodes=ds.full.num_nodes, n_layers=2, n_head=2,
                  dropout=DROPOUT, **model)
    dst = RandEdgeSampler([ds.train.src], [ds.train.dst]).dst_list
    run = dryrun.make_run(kwargs, batches, LR, seed=SEED + 6, state=blob,
                          record=range(DP_CHECKED + 1))
    return dryrun.make_spec(ds.train, ds.full.num_nodes, ds.full.num_edges,
                            ds.node_feat, ds.edge_feat, dst, N_DEGREE, [run])


def dp_chained(ds, spec, res, dev, torch):
    """The dp run's state after its first ``DP_CHECKED`` steps held in a
    row against the plain card step's after the same steps in a row (the
    same batches and draws, float32). Adam turns round-off in a gradient
    into a step of up to lr, and the stream's time deltas of up to 7e5 s
    magnify that in the stored messages' time encodings, so the
    tolerance is a witness measured here: the plain CPU step after the
    same steps in a row, against the same card run. The dp run must be no
    farther from the card run than the CPU run is, in the loss, the
    parameters, each Adam moment (over its tensor's largest) and the float
    memory, and both must have every memory flag equal. Returns both
    distances (``chain_distance``) and the two replays' seconds."""
    from tempme_tpu_torch.parallel import dryrun
    from tempme_tpu_torch.train.learn_tgn import TGNTrainStep
    run, cpu_dev = spec["runs"][0], torch.device("cpu")
    gen = torch.Generator(device=dev)
    gen.manual_seed(run["seed"])      # rank 0's generator, which place shares
    g, feats, dst, model, opt, _ = dryrun.build_run(spec, run, dev)
    drawer = TGNTrainStep(model, g, feats, dst, spec["n"], opt)
    size = run["batches"][0].src.shape[0]
    draws = [to_device(drawer.draw(gen, size), cpu_dev)
             for _ in range(DP_CHECKED)]
    del g, feats, dst, model, opt, drawer
    ref = dryrun.make_run(run["model"], run["batches"][:DP_CHECKED], LR,
                          draws=draws, state=run["state"],
                          record=(DP_CHECKED,))
    t0 = time.perf_counter()
    card = dryrun.replay_plain(dict(spec, runs=[ref]), dev)[0]
    t1 = time.perf_counter()
    cpu = dryrun.replay_plain(dict(spec, runs=[ref]), cpu_dev)[0]
    t2 = time.perf_counter()
    def at(r):
        return dict(r["states"][DP_CHECKED], loss=r["loss"][DP_CHECKED - 1])
    dp, witness = chain_distance(at(res), at(card)), \
        chain_distance(at(cpu), at(card))
    for key, d in dp.items():
        if d > witness[key] or (key == "flags" and d + witness[key]):
            raise AssertionError(
                f"[dp] after {DP_CHECKED} steps in a row: {key} is {d} from "
                f"the card run, the CPU run {witness[key]}")
    return dict(dp=dp, cpu=witness, card_s=t1 - t0, cpu_s=t2 - t1)


def hold_dp_step(got, want, what, start):
    """One dp step's state against the 1-process step's from the same
    state ``start`` (the dp run's record before the step), batch and
    draws, float32 on the card, by ``dryrun.hold_step``: the loss rtol
    1e-4; gradients and Adam's first moments rtol 1e-3, atol 1e-4 of the
    tensor's largest, its second moments rtol 2e-3, atol 2e-4 of the
    largest; the parameters rtol 1e-5, atol 1e-6 where the gradient is at
    least 1e-4 of its tensor's largest, and every dp parameter to the
    float64 replay of Adam from ``start`` with the dp step's own gradient
    at rtol 1e-5, atol 1e-6 (where the gradient is round-off Adam moves an
    entry by up to lr towards its noisy sign, so no bound in lr holds the
    two steps' parameters); a parameter without a gradient unchanged; the
    memory (a TGN's) rtol 2e-4, atol 1e-5, its flags exactly. Returns the
    worst errors. (Steps held in a row, not each from the same state, part
    further: an unsettled entry of the time encoder's frequencies moves by
    up to lr, and the wikipedia-shaped stream's time deltas of up to 7e5 s
    turn that into visible changes of the stored messages' time
    encodings.)"""
    from tempme_tpu_torch.parallel import dryrun
    return dryrun.hold_step(
        got, want, start, what, LR, loss_rtol=1e-4, loss_atol=0.0,
        grad_rtol=1e-3, grad_atol=1e-4, param_rtol=1e-5, param_atol=1e-6,
        mem_rtol=2e-4, mem_atol=1e-5,
        moments={"exp_avg": 1e-3, "exp_avg_sq": 2e-3}, exact_zero=())


def chain_distance(got, want):
    """How far one recorded state is from another after steps held in a
    row: the loss's relative error, the parameters' largest difference,
    Adam's moments' largest difference over their tensor's largest, the
    float memory fields' largest difference, the flag entries that
    differ."""
    import torch
    d = dict(loss=abs(got["loss"] - want["loss"]) / abs(want["loss"]),
             param=0.0, exp_avg=0.0, exp_avg_sq=0.0, memory=0.0, flags=0)
    for name, pb in want["params"].items():
        d["param"] = max(d["param"],
                         (got["params"][name] - pb).abs().max().item())
    for i, sb in want["opt_state"]["state"].items():
        sa = got["opt_state"]["state"][i]
        for key in ("exp_avg", "exp_avg_sq"):
            top = max(sb[key].abs().max().item(), 1e-30)
            d[key] = max(d[key],
                         (sa[key] - sb[key]).abs().max().item() / top)
    for name, mb in want["memory"].items():
        ma = got["memory"][name]
        if mb.dtype == torch.bool:
            d["flags"] += int((ma != mb).sum())
        else:
            d["memory"] = max(d["memory"], (ma - mb).abs().max().item())
    return d


def dp_phase(ds, out, dev, torch):
    """[dp]: (i) the sharded step over nccl at world size 1 in this
    process, bitwise the plain card step over 3 steps (bf16 projections,
    as ``learn_base`` trains; ``dp_world_one``); (ii) 2 ranks spawned on
    this card over gloo with CUDA tensors, 20 global steps of 256 (128 a
    rank) at float32 (``dp_two_ranks``: ranks bitwise equal, each of the
    first 3 steps held against the plain card step from the same state,
    6 launches a rank a step of ``sample_rows``, ``attend_drop`` and
    ``attend_bwd``, the golden's collectives, the step's and the
    collectives' times), then the state after those 3 steps in a row
    against the plain card step's in a row (``dp_chained``). Returns (the
    launches of rank 0 over the 20 steps, numbers)."""
    from tempme_tpu_torch.utils.checkpoint import load_checkpoint
    blob, _ = load_checkpoint(os.path.join(
        out, "params", "tgnn", f"tgn_{DATA_NAME}.pt.train_state"),
        map_location="cpu")
    state = {k: blob[k] for k in ("params", "opt_state", "memory")}
    t0 = time.perf_counter()
    (launches,), (losses,) = dp_world_one([dp_spec(ds, state, DP_CHECKED)],
                                          [DP_PER_STEP], dev, torch)
    say(f"  (i) nccl, world size 1: {DP_CHECKED} steps (bf16, dropout "
        f"{DROPOUT}) bitwise equal to the plain card step: losses "
        f"{losses}; launches {launches}; {time.perf_counter() - t0:.2f} s")
    spec = dp_spec(ds, state, DP_STEPS, compute_dtype=torch.float32)
    (res, _), numbers = dp_two_ranks(spec, DP_PER_STEP, "tgn", "[dp]",
                                     DP_CHECKED, dev, torch)
    chained = dp_chained(ds, spec, res, dev, torch)
    numbers.update({f"chained_{who}_{k}": v for who in ("dp", "cpu")
                    for k, v in chained[who].items()})
    say(f"  after {DP_CHECKED} steps in a row, from the 1-process card "
        f"run: dp {chained['dp']}; the CPU run (the witness) "
        f"{chained['cpu']}; the card and CPU replays took "
        f"{chained['card_s']:.2f} and {chained['cpu_s']:.2f} s")
    return res["launches"], numbers


# [dp-explain] and [dp-enhance]: the explainer's and enhance's dp steps
DP_WALK_STEPS = 10                   # global steps on 2 gloo ranks
DP_WALK_CHECKED = 2                  # the steps held against 1 process


def walk_dp_spec(ds, kind, base_path, steps, seed, compute_dtype=None,
                 explainer_path=None, null_path=None, record=()):
    """A dry-run spec of the explainer (``kind`` ``explainer`` or
    ``tgat-explainer``: the trained explainer of ``explainer_path`` on the
    frozen base of ``base_path``, the prior of ``null_path``) or of
    enhance (``kind`` ``enhance``: a fresh seeded predictor and the base of
    ``base_path`` trained jointly, the degree table of the whole stream) at
    full width on ``ds``'s train split: ``steps`` global batches of 100
    (shuffled with ``seed``), dropout 0.1, the draws from each rank's
    generator (made rank 0's by ``place``)."""
    import numpy as np
    from tempme_tpu_torch.data.events import RandEdgeSampler
    from tempme_tpu_torch.parallel import dryrun
    from tempme_tpu_torch.tools.node_degrees import compute_node_degrees
    from tempme_tpu_torch.train import loops
    from tempme_tpu_torch.utils.checkpoint import load_checkpoint, load_meta
    base_type = load_meta(base_path)["base_type"]
    base = dryrun.checkpoint_base(base_path, compute_dtype)
    batches = loops.stack_batches(ds.train, EXPLAIN_BATCH, True, seed, "cpu")
    batches = [loops.Batch(*(x[i] for x in batches)) for i in range(steps)]
    model = dict(node_dim=ds.node_feat.shape[1],
                 edge_dim=ds.edge_feat.shape[1], dropout=DROPOUT)
    if kind != "tgat-explainer":
        model["base_type"] = base_type
    state = null = None
    if kind != "enhance":
        eblob, _ = load_checkpoint(explainer_path, map_location="cpu")
        state, null = {"params": eblob["params"]}, np.load(null_path)
    run = dryrun.make_run(model, batches, LR, seed=seed + 1, state=state,
                          kind=kind, base=base, null=null, record=record)
    dst = RandEdgeSampler([ds.train.src], [ds.train.dst]).dst_list
    return dryrun.make_spec(
        ds.train, ds.full.num_nodes, ds.full.num_edges, ds.node_feat,
        ds.edge_feat, dst, N_DEGREE, [run],
        node_degree=compute_node_degrees(ds.full) if kind == "enhance"
        else None)


def dp_world_one(specs, per_step, dev, torch):
    """Each spec's run through the sharded step over nccl at world size 1
    in this process, bitwise the plain card step; ``per_step`` its
    launches a step. Returns rank 0's launches of each."""
    from tempme_tpu_torch.parallel import dryrun, mesh, multihost
    import torch.distributed as dist
    plain = [dryrun.replay_plain(spec, dev) for spec in specs]
    multihost.initialize("nccl", f"tcp://localhost:{dryrun.free_port()}",
                         world_size=1, rank=0, device=dev)
    try:
        got = [dryrun.replay(spec, mesh.make_mesh(), dev) for spec in specs]
    finally:
        dist.destroy_process_group()
    out = []
    for spec, want, have, per in zip(specs, plain, got, per_step):
        dryrun.assert_ranks_equal([want, have])
        steps = len(spec["runs"][0]["batches"])
        check_launches(have[0]["launches"],
                       {k: v * steps for k, v in per.items()})
        out.append(have[0]["launches"])
    return out, [g[0]["loss"] for g in got]


def dp_two_ranks(spec, per_step, golden, what, checked, dev, torch,
                 mesh=(2, 1, 1)):
    """``spec``'s run (float32, timed) on the gloo ranks of ``mesh`` (2 dp
    ranks by default) spawned on this card: every rank's (whole) state
    bitwise equal, ``per_step`` launches a rank a step, the collectives of
    every step the golden's (``GOLDEN_COLLECTIVES``), and each of the
    first ``checked`` steps held against the 1-process card step from the
    same state (``hold_dp_step``). Returns (every rank's results, numbers);
    rank 0's first."""
    import statistics
    from tempme_tpu_torch.parallel import dryrun
    from tempme_tpu_torch.parallel.train import GOLDEN_COLLECTIVES
    world = mesh[0] * mesh[1] * mesh[2]
    steps = len(spec["runs"][0]["batches"])
    batch = spec["runs"][0]["batches"][0].src.shape[0]
    spec["runs"][0]["timed"] = True
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dp_walk_") as work:
        ranks = dryrun.run_spec(spec, world, "gloo", f"cuda:{dev.index or 0}",
                                work, threads=2, timeout=400, mesh=mesh)
    ranks_s = time.perf_counter() - t0
    dryrun.assert_ranks_equal(ranks)
    for rank in ranks:
        check_launches(rank[0]["launches"],
                       {k: v * steps for k, v in per_step.items()})
    res, run = ranks[0][0], spec["runs"][0]
    for rank in ranks:
        for c in rank[0]["comm"]:
            if c["by_kind"] != GOLDEN_COLLECTIVES[golden]:
                raise AssertionError(f"{what}: collectives {c['by_kind']}, "
                                     f"golden {GOLDEN_COLLECTIVES[golden]}")
    refs = [dict(run, batches=[run["batches"][k - 1]],
                 state=res["states"][k - 1], record=(1,), timed=False)
            for k in range(1, checked + 1)]
    plain = dryrun.replay_plain(dict(spec, runs=refs), dev)
    worst = {}
    for k, ref in enumerate(plain, start=1):
        w = hold_dp_step(dryrun.at_step(res, k), dryrun.at_step(ref, 1),
                         f"{what} step {k}", res["states"][k - 1])
        worst = {key: max(v, worst.get(key, 0.0)) for key, v in w.items()}
    comm = res["comm"]
    numbers = dict(
        step_ms=statistics.median(res["wall_ms"]),
        step_ms_min=min(res["wall_ms"]), step_ms_max=max(res["wall_ms"]),
        collective_ms=statistics.median(c["ms"] for c in comm),
        collective_bytes=comm[0]["bytes"], collectives=comm[0]["by_kind"],
        ranks_s=ranks_s, **{f"worst_{k}": v for k, v in worst.items()})
    say(f"  (ii) {world} gloo ranks of mesh {'x'.join(map(str, mesh))} on "
        f"one card (CUDA tensors), {steps} global steps of {batch} at "
        f"float32: ranks bitwise equal; each of the first {checked} against "
        f"the 1-process card step from the same state, batch and draws: "
        f"worst loss rtol {worst['loss']:.3e}, gradient {worst['grad']:.3e} "
        f"of its tensor's largest, settled param {worst['param']:.3e}, "
        f"every param within {worst['replay']:.3e} of its Adam replay, "
        f"memory {worst['memory']:.3e}; launches a rank a step "
        f"{ {k: v // steps for k, v in res['launches'].items()} }; "
        f"collectives a step {comm[0]['by_kind']} (the golden's, {golden})")
    say(f"  step {numbers['step_ms']:.3f} ms median wall (min "
        f"{numbers['step_ms_min']:.3f}, max {numbers['step_ms_max']:.3f}, "
        f"with a device sync around each collective), collectives "
        f"{numbers['collective_ms']:.3f} ms and "
        f"{numbers['collective_bytes']:,} bytes a rank a step; the {world} "
        f"ranks took {ranks_s:.2f} s with their start. The ranks share one "
        f"card: not a scaling measurement; {gpu_line()}")
    return [r[0] for r in ranks], numbers


# [sp-tp]: the TGN step on the sp and tp mesh axes, 2 or 4 gloo ranks on
# the card: (mesh, global steps)
SP_TP_MESHES = (((1, 2, 1), 5), ((1, 1, 2), 5), ((2, 2, 1), 3))


def sp_tp_phase(ds, out, dev, torch):
    """[sp-tp]: the sharded TGN step on the meshes of ``SP_TP_MESHES``
    from [train]'s checkpoint at width 172, float32, batch 256, dropout
    0.1 (``dp_two_ranks`` at each mesh: whole states bitwise equal across
    ranks, the first 3 steps against the 1-process card step, the
    golden's collectives), then per mesh what each rank holds: the
    memory blocks of one sp index bitwise equal across dp indices, and
    each rank's ``memory`` and ``msg_buf`` bytes beside the 1-process
    state's, its tp shards ``out/tp`` rows. Returns (rank 0's launches
    summed over the meshes, numbers)."""
    from tempme_tpu_torch.parallel import mesh as M
    from tempme_tpu_torch.parallel.train import golden_kind
    from tempme_tpu_torch.utils.checkpoint import load_checkpoint
    from tempme_tpu_torch.utils.convert import tp_sharded_names
    blob, _ = load_checkpoint(os.path.join(
        out, "params", "tgnn", f"tgn_{DATA_NAME}.pt.train_state"),
        map_location="cpu")
    state = {k: blob[k] for k in ("params", "opt_state", "memory")}
    nodes = ds.full.num_nodes
    whole = {k: blob["memory"][k].numel() * blob["memory"][k].element_size()
             for k in ("memory", "msg_buf")}
    shapes = {k: tuple(v.shape) for k, v in blob["params"].items()}
    numbers, launches = {}, {}
    for mesh, steps in SP_TP_MESHES:
        name = "x".join(map(str, mesh))
        t0 = time.perf_counter()
        spec = dp_spec(ds, state, steps, compute_dtype=torch.float32)
        ranks, nums = dp_two_ranks(spec, DP_PER_STEP,
                                   golden_kind(M.Mesh(*mesh, rank=0)),
                                   f"[sp-tp {name}]", DP_CHECKED, dev, torch,
                                   mesh)
        rows = M.row_block(nodes, mesh[1], 0)[1]
        names = tp_sharded_names(shapes, mesh[2])
        by_sp = {}
        for r in ranks:
            local = r["local"]
            mem = local["shapes"]["memory"]
            if mem["memory"][0] != rows or mem["msg_buf"][0] != rows:
                raise AssertionError(f"[sp-tp {name}]: rank holds "
                                     f"{mem['memory'][0]} memory rows, want "
                                     f"{rows}")
            for k in names:
                got = local["shapes"]["params"][k][0]
                moments = local["shapes"]["moments"][k]
                want = shapes[k][0] // mesh[2]
                if got != want or any(m[0] != want
                                      for m in moments.values()):
                    raise AssertionError(f"[sp-tp {name}] {k}: {got} rows, "
                                         f"moments {moments}, want {want}")
            s = local["coords"][1]
            if s in by_sp and not (
                    torch.equal(by_sp[s]["memory"], local["memory"]) and
                    torch.equal(by_sp[s]["msg_buf"], local["msg_buf"])):
                raise AssertionError(f"[sp-tp {name}]: the memory blocks of "
                                     f"sp index {s} differ across dp")
            by_sp[s] = local
        held = {k: rows * (whole[k] // nodes) for k in whole}
        say(f"  each rank holds {rows} of {nodes} memory rows: memory "
            f"{held['memory']:,} B and msg_buf {held['msg_buf']:,} B (the "
            f"1-process state {whole['memory']:,} and {whole['msg_buf']:,} "
            f"B); {len(names)} tp-sharded weights at out/{mesh[2]} rows "
            f"with their Adam moments; the memory blocks of each sp index "
            f"equal across dp; {time.perf_counter() - t0:.2f} s")
        nums.update(memory_bytes=held["memory"], msg_buf_bytes=held[
            "msg_buf"], whole_memory_bytes=whole["memory"],
            whole_msg_buf_bytes=whole["msg_buf"], tp_sharded=len(names))
        numbers[name] = nums
        for k, v in ranks[0]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return launches, numbers


def dp_explain_phase(ds, ckpt_dir, tgat_ckpt, dev, torch):
    """[dp-explain]: the explainer's dp step at full width from the
    checkpoints of [explain] (the TGN explainer) and [tgat-explain]: (i)
    over nccl at world size 1 in this process, bitwise the plain card step
    over 3 steps of the TGN explainer and 2 of the TGAT explainer (bf16
    projections, dropout 0.1, the gamma draws from the generator); (ii)
    the TGN explainer on 2 gloo ranks sharing this card (``dp_two_ranks``,
    golden ``explainer``). Returns (launches per path, numbers)."""
    def spec(base_type, ckpt, data, steps, dtype=None, record=()):
        kind = "tgat-explainer" if base_type == "tgat" else "explainer"
        return walk_dp_spec(
            ds, kind, os.path.join(ckpt, "tgnn", f"{base_type}_{data}.pt"),
            steps, SEED + 21, dtype,
            os.path.join(ckpt, "explainer", base_type, f"{data}.pt"),
            os.path.join(ckpt, f"null_{data}_n{N_DEGREE}_s{SEED}.npy"),
            record)
    t0 = time.perf_counter()
    (tgn_l, tgat_l), losses = dp_world_one(
        [spec("tgn", ckpt_dir, EXPLAIN_DATA, DP_CHECKED),
         spec("tgat", tgat_ckpt, TGAT_DATA, 2)],
        [EXPLAIN_PER_STEP["train"], TGAT_EXPLAIN_PER_STEP["train"]], dev,
        torch)
    say(f"  (i) nccl, world size 1: the TGN explainer's {DP_CHECKED} steps "
        f"and the TGAT explainer's 2 (bf16, dropout {DROPOUT}) bitwise "
        f"equal to the plain card step: losses {losses[0]}, {losses[1]}; "
        f"launches {tgn_l}, {tgat_l}; {time.perf_counter() - t0:.2f} s")
    (res, _), numbers = dp_two_ranks(
        spec("tgn", ckpt_dir, EXPLAIN_DATA, DP_WALK_STEPS, torch.float32,
             range(DP_WALK_CHECKED + 1)),
        EXPLAIN_PER_STEP["train"], "explainer", "[dp-explain]",
        DP_WALK_CHECKED, dev, torch)
    return {"dp-explain": res["launches"]}, numbers


def dp_enhance_phase(ds_tgn, tgn_base, ds, mixer_base, dev, torch):
    """[dp-enhance]: enhance's dp step at full width, a fresh seeded
    predictor with the TGN of [enhance-tgn]'s base (``tgn_base``, on
    ``ds_tgn``) or the GraphMixer of [mixer-train] (``mixer_base``, on
    ``ds``): (i) over nccl at world size 1 in this process, bitwise the
    plain card step over 3 TGN steps and 2 GraphMixer steps (bf16
    projections, dropout 0.1); (ii) the TGN's on 2 gloo ranks sharing this
    card (``dp_two_ranks``, golden ``enhance-tgn``). Returns (launches per
    path, numbers)."""
    t0 = time.perf_counter()
    (tgn_l, mixer_l), losses = dp_world_one(
        [walk_dp_spec(ds_tgn, "enhance", tgn_base, DP_CHECKED, SEED + 23),
         walk_dp_spec(ds, "enhance", mixer_base, 2, SEED + 24)],
        [ENHANCE_PER_STEP["tgn"]["train"],
         ENHANCE_PER_STEP["graphmixer"]["train"]], dev, torch)
    say(f"  (i) nccl, world size 1: the TGN enhance's {DP_CHECKED} steps and "
        f"the GraphMixer enhance's 2 (bf16, dropout {DROPOUT}) bitwise equal "
        f"to the plain card step: losses {losses[0]}, {losses[1]}; launches "
        f"{tgn_l}, {mixer_l}; {time.perf_counter() - t0:.2f} s")
    (res, _), numbers = dp_two_ranks(
        walk_dp_spec(ds_tgn, "enhance", tgn_base, DP_WALK_STEPS, SEED + 23,
                     torch.float32, record=range(DP_WALK_CHECKED + 1)),
        ENHANCE_PER_STEP["tgn"]["train"], "enhance-tgn", "[dp-enhance]",
        DP_WALK_CHECKED, dev, torch)
    return {"dp-enhance": res["launches"]}, numbers


EXPLAIN_BATCH = 100
EXPLAIN_RESUME_STEP = 50


def union_bytes(g, a, b, e, n):
    """Bytes one sample_union call must move for these inputs: per query
    its three ids and the edge time, four offsets and each side's bisect
    probes (about log2(degree + 1) timestamps where the side is not forced
    empty), the n draws, 3n table reads where the union is not empty and 4n
    outputs."""
    import torch
    from tempme_tpu_torch.ops.kernels.sample_rows import cut_by_edge
    live = (e != 0)
    probes = 0.0
    for v in (a, b):
        deg = (g.off[v.long() + 1] - g.off[v.long()]).double()
        probes += (torch.ceil(torch.log2(deg + 1)) * (live & (v != 0))).sum()
    total = cut_by_edge(g, a, e)[1] + cut_by_edge(g, b, e)[1]
    q = a.shape[0]
    return q * (16 + 16) + 4 * probes.item() + q * n * 4 \
        + (total > 0).sum().item() * n * 12 + q * n * 16


def masked_bytes(g, a, b, e, wildcard, found):
    """Bytes one sample_masked call must move for these inputs: per query
    its eight inputs, the edge time and four offsets; wildcard rows the two
    time bisects' probes (4 bytes each), the others up to six (neighbour,
    time) bisects' probes (8 bytes each) on the sides that are not empty;
    one entry of three arrays where a candidate exists; five outputs."""
    import torch
    probes = 0.0
    for v, per_row in ((a, 4), (b, 2)):
        deg = (g.off[v.long() + 1] - g.off[v.long()]).double()
        p = torch.ceil(torch.log2(deg + 1)) * ((v != 0) & (e != 0))
        probes += (p * torch.where(wildcard, 4.0, 8.0 * per_row)).sum()
    q = a.shape[0]
    return q * (29 + 4 + 16 + 17) + probes.item() + found.sum().item() * 12


def check_walk_kernels(ds, g, torch, dev):
    """The three walk kernels against their plain versions at the
    explainer's shapes, on inputs captured from its own sampling and
    forward: ``sample_union`` at Q = 2,000 x 3 draws and ``sample_masked``
    at Q = 6,000 (each also on its first 129 queries) bitwise; ``walk_to_edge`` at
    [100, 180] slots against [100, 20] (hop 0) and [100, 400] (hop 1)
    targets, the forward exactly (``out`` and ``cnt``) and its backward to
    rtol 1e-5, atol 1e-5 (each slot sums its share over up to T targets, in
    another order). Returns the rows and the errors."""
    from tempme_tpu_torch.ops.kernels.sample_masked import (
        sample_masked, sample_masked_plain)
    from tempme_tpu_torch.ops.kernels.sample_union import (
        sample_union, sample_union_plain)
    from tempme_tpu_torch.ops.kernels.walk_to_edge import (
        walk_to_edge_bwd, walk_to_edge_count_plain, walk_to_edge_fwd,
        walk_to_edge_plain)
    from tempme_tpu_torch.tools.walk_ab import capture_walk_inputs
    rec = capture_walk_inputs(ds, g, dev, EXPLAIN_BATCH, N_DEGREE, SEED)
    rows, errs = {}, {}
    (ua,) = rec["sample_union"][:1]
    (ma,) = rec["sample_masked"][:1]
    # each also on its first 129 queries, the shape of tools/walk_ab.py's
    # latency-floor rows
    ua129 = [t[:129].contiguous() for t in ua[1:]]
    for name, kernel, plain, args, nbytes in (
            ("sample_union", sample_union, sample_union_plain, ua[1:],
             union_bytes(g, *ua[1:4], ua[4].shape[1])),
            ("sample_union Q=129", sample_union, sample_union_plain, ua129,
             union_bytes(g, *ua129[:3], ua[4].shape[1])),
            ("sample_masked", sample_masked, sample_masked_plain, ma[1:],
             None),
            ("sample_masked Q=129", sample_masked, sample_masked_plain,
             [t[:129].contiguous() for t in ma[1:]], None)):
        got, want = kernel(g, *args), plain(g, *args)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"{name} differs from its plain version")
        if not (got[1] > 0).any():
            raise AssertionError(f"{name} sampled nothing")
        if nbytes is None:
            nbytes = masked_bytes(g, args[0], args[1], args[2], args[6],
                                  got[4])
        ms, host = time_ms(lambda: kernel(g, *args))
        plain_ms, plain_host = time_ms(lambda: plain(g, *args))
        least, by = bound(nbytes, 0)
        q = args[0].shape[0]
        shape, found = f"Q={q}", ""
        if name.startswith("sample_union"):
            shape += (f" x {args[3].shape[1]} (a warp a query, both cuts as "
                      f"17-ary lower bounds, a pick a lane)")
        if name.startswith("sample_masked"):
            deg = g.off[1:] - g.off[:-1]
            top = max(int(deg[v.long()].max()) for v in args[:2])
            found = (f", {int(got[4].sum())} of {q} found, "
                     f"{int(args[6].sum())} wildcard, largest degree "
                     f"queried {top}")
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=least,
                          bound_by=by, library_ms=None)
        errs[name] = 0.0
        say(f"  {name.split()[0]} {shape}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, "
            f"bound {least:.5f} ms ({by}), bitwise equal{found}; eager "
            f"calls from the host {host:.4f} / {plain_host:.4f} ms; no "
            f"library call (no one PyTorch call samples a temporal CSR)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 23)
    fwd_err = bwd_err = 0.0
    for ids, imp, tgt in rec["walk_to_edge"][:2]:
        ids, tgt = ids.to(torch.int32), tgt.to(torch.int32)
        b, s_len = ids.shape
        t = tgt.shape[1]
        out, cnt = walk_to_edge_fwd(ids, imp, tgt)
        ref = walk_to_edge_plain(ids, imp, tgt)
        ref_cnt = walk_to_edge_count_plain(ids, imp, tgt)
        ct = torch.randn((b, t), generator=gen, device=dev)
        g_imp = walk_to_edge_bwd(ids, imp, tgt, out, cnt, ct)
        with torch.enable_grad():
            leaf = imp.detach().requires_grad_()
            (g_ref,) = torch.autograd.grad(
                walk_to_edge_plain(ids, leaf, tgt), [leaf], ct)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise AssertionError("walk_to_edge differs from its plain version")
        if not torch.equal(cnt, ref_cnt):
            raise AssertionError("walk_to_edge: cnt differs from the plain "
                                 "count")
        torch.testing.assert_close(g_imp, g_ref, rtol=1e-5, atol=1e-5)
        bwd_err = max(bwd_err, (g_imp - g_ref).abs().max().item())
        if not (out > 0).any():
            raise AssertionError("walk_to_edge: no target matched a walk")

        def plain_bwd():
            with torch.enable_grad():
                leaf = imp.detach().requires_grad_()
                return torch.autograd.grad(
                    walk_to_edge_plain(ids, leaf, tgt), [leaf], ct)
        # the forward reads the slots' ids and importances and the targets
        # (4 bytes each) and writes out and cnt (8 bytes a target); its
        # table does about 8 integer operations a slot (hash, insert, max,
        # counts) and a target (hash, probe, selects), not the B * T * S
        # compares. The backward: two compares and an add per (target,
        # slot). Operations at the INT32 rate
        for name, fn, pfn, nbytes, ops in (
                (f"walk_to_edge T={t}", lambda: walk_to_edge_fwd(ids, imp, tgt),
                 lambda: walk_to_edge_plain(ids, imp, tgt),
                 b * s_len * 8 + b * t * 12, 8 * b * (s_len + t)),
                (f"walk_to_edge_bwd T={t}",
                 lambda: walk_to_edge_bwd(ids, imp, tgt, out, cnt, ct),
                 plain_bwd, b * s_len * 12 + b * t * 8, 3 * b * t * s_len)):
            ms, host = time_ms(fn)
            plain_ms, plain_host = time_ms(pfn)
            least, by = bound(nbytes, ops, H100_INT32_OPS_PER_S)
            rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=least,
                              bound_by=by, library_ms=None)
            say(f"  {name} [{b}, {s_len}] slots: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {least:.5f} ms ({by}); eager calls "
                f"from the host {host:.4f} / {plain_host:.4f} ms; no library "
                f"call (scatter_reduce amax onto a dense table, then a "
                f"gather: two calls)")
    errs["walk_to_edge"], errs["walk_to_edge_bwd"] = fwd_err, bwd_err
    say(f"  walk_to_edge forward exactly equal, cnt equal to the plain "
        f"count; backward max abs err "
        f"{bwd_err:.3e} (rtol 1e-5, atol 1e-5)")
    return rows, errs


def explain_kernels():
    from tempme_tpu_torch.ops.kernels.attend import (attend, attend_bwd,
                                                     attend_drop)
    from tempme_tpu_torch.ops.kernels.sample_masked import sample_masked
    from tempme_tpu_torch.ops.kernels.sample_rows import sample_rows
    from tempme_tpu_torch.ops.kernels.sample_union import sample_union
    from tempme_tpu_torch.ops.kernels.walk_to_edge import (walk_to_edge_bwd,
                                                           walk_to_edge_fwd)
    return {"sample_rows": sample_rows, "sample_union": sample_union,
            "sample_masked": sample_masked, "walk_to_edge": walk_to_edge_fwd,
            "walk_to_edge_bwd": walk_to_edge_bwd, "attend": attend,
            "attend_drop": attend_drop, "attend_bwd": attend_bwd}


# launches per step of each kernel on the explainer's path: a train step
# samples 3 sides x 2 hops and each side's walk events 2 and 3, carries the
# walk importance onto both hops of 3 sides and back, and runs the frozen
# base twice (the labels, then the explained contrast: 3 sides x 2 layers
# each) and the explained one's backward; an eval step has no backward and
# adds the ratio sweep's hop-0 level (one attend per side); a batch of the
# null model's estimate samples supports and walks only
EXPLAIN_PER_STEP = {
    "train": dict(sample_rows=6, sample_union=3, sample_masked=3,
                  walk_to_edge=6, walk_to_edge_bwd=6, attend=12,
                  attend_drop=0, attend_bwd=6),
    "eval": dict(sample_rows=6, sample_union=3, sample_masked=3,
                 walk_to_edge=6, walk_to_edge_bwd=0, attend=15,
                 attend_drop=0, attend_bwd=0),
    "null": dict(sample_rows=6, sample_union=3, sample_masked=3,
                 walk_to_edge=0, walk_to_edge_bwd=0, attend=0,
                 attend_drop=0, attend_bwd=0)}


def explain_base_dir(work, ckpt_dir, data=None, name="explain_base"):
    """A checkpoint directory ``{work}/{name}/params`` whose
    ``tgnn/tgn_{data}.pt`` is the TGN of [train] (``ckpt_dir``): trained
    on the whole stream, it runs on a cut whose node table is the
    stream's. [explain] explains it on ``ml_{EXPLAIN_DATA}`` (the default
    ``data``)."""
    import shutil
    data = data or EXPLAIN_DATA
    mine = os.path.join(work, name, "params")
    os.makedirs(os.path.join(mine, "tgnn"))
    for suffix in ("", ".json"):
        shutil.copy(os.path.join(ckpt_dir, "tgnn",
                                 f"tgn_{DATA_NAME}.pt{suffix}"),
                    os.path.join(mine, "tgnn", f"tgn_{data}.pt{suffix}"))
    return mine


def explain_argv(ds_dir, ckpt_dir, out, *extra, base_type="tgn",
                 data=DATA_NAME):
    return ["--data", data, "--data_dir", ds_dir, "--base_type", base_type,
            "--bs", str(EXPLAIN_BATCH), "--test_bs", str(EXPLAIN_BATCH),
            "--n_epoch", "1", "--seed", str(SEED), "--ckpt_dir", ckpt_dir,
            "--log_dir", os.path.join(out, "tb"),
            "--results_dir", os.path.join(out, "results"), *extra]


def explain(ds, ds_dir, ckpt_dir, out, torch, base_type="tgn",
            data=DATA_NAME, per_step=None, resume_step=EXPLAIN_RESUME_STEP):
    """One epoch of ``temp_exp_main.main`` at full width on the card, on
    the base that [train] (a TGN) or [tgat-train] wrote, with ``per_step``
    launches of each kernel per train, eval and null-model step. Returns
    (launches, numbers, results path, the mid-epoch state's snapshot)."""
    per_step = per_step or EXPLAIN_PER_STEP
    argv_kw = dict(base_type=base_type, data=data)
    import math
    import shutil
    import numpy as np
    from tempme_tpu_torch.data.events import shuffled_events, split_events
    from tempme_tpu_torch.train import temp_exp_main
    kernels = explain_kernels()
    steps = {"train": len(ds.train) // EXPLAIN_BATCH,
             "eval": math.ceil(len(ds.val) / EXPLAIN_BATCH)
             + math.ceil(len(ds.test) / EXPLAIN_BATCH),
             "null": min(50, len(split_events(
                 shuffled_events(ds.full, seed=SEED), ds.node_feat,
                 ds.edge_feat).test) // 10)}
    want = {k: sum(per_step[p][k] * n for p, n in steps.items())
            for k in kernels}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in kernels.values():
        f.launches = 0
    # the run also writes a mid-epoch checkpoint; a copy of it is the
    # state of a run stopped right there ([explain-resume] resumes it)
    save = temp_exp_main.save_checkpoint
    snapshot = os.path.join(out, "stopped.train_state")

    def snapshotting_save(path, blob, meta=None):
        save(path, blob, meta=meta)
        if meta and meta.get("step") == resume_step:
            shutil.copy(path, snapshot)
            shutil.copy(path + ".json", snapshot + ".json")

    temp_exp_main.save_checkpoint = snapshotting_save
    t0 = time.perf_counter()
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            best = temp_exp_main.main(explain_argv(
                ds_dir, ckpt_dir, out, "--ckpt_every_steps",
                str(resume_step), **argv_kw))
    finally:
        temp_exp_main.save_checkpoint = save
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: f.launches for name, f in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    for line in printed.getvalue().splitlines():
        say(f"    | {line}")
    say(f"  launches on the explainer's path: {launches} for "
        f"{steps['train']} train, {steps['eval']} eval and {steps['null']} "
        f"null-model steps; per step {per_step}")
    check_launches(launches, want)
    tags = read_metrics(out)
    losses = tags["Train/step_loss"]
    if len(losses) != steps["train"] or not all(map(math.isfinite, losses)):
        raise AssertionError("an explainer loss is missing or not finite")
    tenth = max(1, steps["train"] // 10)
    first, last = (sum(x) / len(x) for x in (losses[:tenth],
                                              losses[-tenth:]))
    eps = tags["Train/events_per_s"][0]
    numbers = dict(train_ms_per_step=EXPLAIN_BATCH / eps * 1e3,
                   events_per_s=eps, loss_first_tenth=first,
                   loss_last_tenth=last,
                   train_fid_prob=tags["Train/fid_prob"][0],
                   train_fid_logit=tags["Train/fid_logit"][0],
                   peak_gib=peak / 2 ** 30, wall_s=wall, best_val=best)
    for split in ("Val", "Test"):
        for key in ("aps", "auc", "acc", "fid_prob", "fid_logit", "r_aps",
                    "r_auc", "r_acc", "r_prob", "r_logit"):
            numbers[f"{split.lower()}_{key}"] = tags[f"{split}/{key}"][0]
    for key in ("val_aps", "test_aps", "val_r_aps", "test_r_aps"):
        if not 0.0 <= numbers[key] <= 1.0:
            raise AssertionError(f"{key} {numbers[key]} outside [0, 1]")
    for key in ("test_fid_prob", "test_fid_logit", "test_r_prob",
                "test_r_logit"):
        if not math.isfinite(numbers[key]):
            raise AssertionError(f"{key} is not finite")
    ckpt = os.path.join(ckpt_dir, "explainer", base_type, f"{data}.pt")
    results = os.path.join(out, "results",
                           f"explainer_{base_type}_{data}.json")
    null = os.path.join(ckpt_dir, f"null_{data}_n{N_DEGREE}_s{SEED}.npy")
    for path in (ckpt, ckpt + ".json", ckpt + ".train_state", results, null,
                 snapshot):
        if not os.path.exists(path):
            raise AssertionError(f"missing {path}")
    null_dist = np.load(null)
    if null_dist.shape != (12,) or abs(float(null_dist.sum()) - 1.0) > 1e-5:
        raise AssertionError(f"null distribution {null_dist}")
    say(f"  {steps['train']} steps: {numbers['train_ms_per_step']:.3f} "
        f"ms/step, {eps:.1f} events/s (the driver's epoch clock); mean loss "
        f"first tenth {first:.6f}, last tenth {last:.6f}; train fid_prob "
        f"{numbers['train_fid_prob']:.6f}, fid_logit "
        f"{numbers['train_fid_logit']:.6f}; val AP {numbers['val_aps']:.6f},"
        f" test AP {numbers['test_aps']:.6f}; test fid_prob "
        f"{numbers['test_fid_prob']:.6f}, fid_logit "
        f"{numbers['test_fid_logit']:.6f}; 16-ratio sweep on test: APS "
        f"{numbers['test_r_aps']:.6f}, AUC {numbers['test_r_auc']:.6f}, ACC "
        f"{numbers['test_r_acc']:.6f}, prob {numbers['test_r_prob']:.6f}, "
        f"logit {numbers['test_r_logit']:.6f}; peak device memory "
        f"{numbers['peak_gib']:.3f} GiB; main() {wall:.2f} s with loading, "
        f"the null model and eval")
    say(f"  null distribution (CAT_ORDER): {np.round(null_dist, 4).tolist()}")
    return launches, numbers, results, snapshot


def explain_resume(ds_dir, ckpt_dir, out, snapshot, base_type="tgn",
                   data=DATA_NAME, resume_step=EXPLAIN_RESUME_STEP):
    """``--resume`` to the end of the epoch from ``snapshot``, the state
    the [explain] (or [tgat-explain]) run wrote at its mid-epoch checkpoint
    (a run stopped right after that checkpoint leaves exactly that state),
    in a fresh checkpoint directory holding the base and the null
    distribution."""
    import shutil
    from tempme_tpu_torch.train import temp_exp_main
    mine = os.path.join(out, "params")
    shutil.copytree(os.path.join(ckpt_dir, "tgnn"),
                    os.path.join(mine, "tgnn"))
    for f in glob.glob(os.path.join(ckpt_dir, "null_*.npy")):
        shutil.copy(f, mine)
    state = os.path.join(mine, "explainer", base_type,
                         f"{data}.pt.train_state")
    os.makedirs(os.path.dirname(state))
    shutil.copy(snapshot, state)
    shutil.copy(snapshot + ".json", state + ".json")
    with open(state + ".json") as f:
        meta = json.load(f)
    if (meta["epoch"], meta["step"]) != (0, resume_step):
        raise AssertionError(f"mid-epoch checkpoint meta {meta}")
    argv = explain_argv(ds_dir, mine, out, "--ckpt_every_steps",
                        str(resume_step), base_type=base_type, data=data)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        best = temp_exp_main.main(argv + ["--resume"])
    if f"at epoch 0 step {resume_step}" not in printed.getvalue():
        raise AssertionError("the second run did not resume mid-epoch")
    for line in printed.getvalue().splitlines()[-6:]:
        say(f"    | {line}")
    with open(state + ".json") as f:
        meta = json.load(f)
    if meta["epoch"] != 0 or "step" in meta or not 0.0 <= best <= 1.0:
        raise AssertionError(f"the resumed run did not finish: {meta}")


def explain_eval_only(ds_dir, ckpt_dir, out, results, base_type="tgn",
                      data=DATA_NAME):
    """``--eval_only`` on the saved explainer: the test metrics of the
    best epoch again (within 1e-6)."""
    from tempme_tpu_torch.train import temp_exp_main
    with contextlib.redirect_stdout(io.StringIO()):
        ev = temp_exp_main.main(explain_argv(ds_dir, ckpt_dir, out,
                                             "--eval_only",
                                             base_type=base_type, data=data))
    with open(results) as f:
        saved = json.load(f)
    worst = max(abs(ev[k] - saved[k]) for k in ev)
    if not worst <= 1e-6:
        raise AssertionError(f"--eval_only gave {ev}, the run saved {saved}")
    say(f"  test metrics of the saved explainer reproduced (max difference "
        f"{worst:.3e}): APS {ev['aps']:.6f}, ratio APS {ev['r_aps']:.6f}")


def explainer_steps_on(dev, ds, ckpt_dir, compute_dtype, base_type="tgn",
                       data=DATA_NAME):
    """The explainer's train and eval steps on ``dev`` from the checkpoints
    of [train] and [explain] (or [mixer-train] and [mixer-explain]): the
    frozen base (a TGN's projections at ``compute_dtype``), the trained
    explainer, a fresh Adam, the graphs, features and tables."""
    import numpy as np
    import torch
    from tempme_tpu_torch.data.events import RandEdgeSampler
    from tempme_tpu_torch.data.graph import build_temporal_graph
    from tempme_tpu_torch.explain.tempme import TempME
    from tempme_tpu_torch.models.common import Features
    from tempme_tpu_torch.train import temp_exp_main as X
    from tempme_tpu_torch.train.base_loader import load_base
    from tempme_tpu_torch.utils.checkpoint import load_checkpoint
    base = load_base(os.path.join(ckpt_dir, "tgnn",
                                  f"{base_type}_{data}.pt"),
                     device=dev, compute_dtype=compute_dtype)
    nn_, ne = ds.full.num_nodes, ds.full.num_edges
    g_train = build_temporal_graph(ds.train, nn_, ne, device=dev)
    g_full = build_temporal_graph(ds.full, nn_, ne, device=dev)
    feats = Features(torch.from_numpy(ds.node_feat).to(dev),
                     torch.from_numpy(ds.edge_feat).to(dev))
    null = torch.from_numpy(np.load(os.path.join(
        ckpt_dir, f"null_{data}_n{N_DEGREE}_s{SEED}.npy"))).to(dev)
    explainer = TempME(ds.node_feat.shape[1], ds.edge_feat.shape[1],
                       base_type=base_type, device=dev, seed=SEED)
    blob, _ = load_checkpoint(os.path.join(
        ckpt_dir, "explainer", base_type, f"{data}.pt"), map_location=dev)
    explainer.load_state_dict(blob["params"])
    opt = torch.optim.Adam(explainer.parameters(), lr=LR)

    def table(*lists):
        return torch.from_numpy(RandEdgeSampler(*lists).dst_list).to(dev)
    train = X.ExplainerTrainStep(explainer, base, g_train, feats,
                                 table([ds.train.src], [ds.train.dst]),
                                 N_DEGREE, null, opt)
    ev = X.ExplainerEvalStep(
        explainer, base, g_full, feats,
        table([ds.train.src, ds.val.src, ds.test.src],
              [ds.train.dst, ds.val.dst, ds.test.dst]), N_DEGREE, null)
    return train, ev


def explainer_draws(step, gen, sample=True):
    """A train step's draws at batch 100 from the CPU generator ``gen``,
    the Beta sample's gamma draws among them (``sample`` False: no support
    or walk draws, the inputs come from the walk cache)."""
    import torch
    n, b = N_DEGREE, EXPLAIN_BATCH
    draws = step.draw(gen, b, sample=sample)
    return draws._replace(gamma=tuple(
        tuple(torch._standard_gamma(torch.full(shape, 2.0), generator=gen)
              for shape in ((b, n), (b, n), (b, n * n), (b, n * n)))
        for _ in range(3)))


def compare_explainer_train_steps(tc, tg, batch, draws, dev, inputs=None):
    """The explainer train steps ``tc`` (CPU) and ``tg`` (card) on the same
    batch, draws and, when given, cached ``inputs`` (on the CPU): loss rtol
    1e-4; gradients rtol 1e-3, atol 1e-4 of each tensor's largest; params
    after Adam rtol 1e-5, atol 1e-6 where the gradient is settled, and
    every card parameter to the float64 replay of Adam from the shared
    starting state with the card's own gradient at rtol 1e-5, atol 1e-6
    (``check_explainer_against_cpu``; a round-off gradient's sign differs
    between the sides, and Adam moves such an entry by up to lr towards
    it, so no bound in lr holds the two sides' parameters)."""
    import torch
    from tempme_tpu_torch.utils.optim import hold_adam_step
    start = {name: (p.detach().cpu().clone(), copy.deepcopy(
        {k: v.cpu() if torch.is_tensor(v) else v
         for k, v in tg.optimizer.state.get(p, {}).items()}))
        for name, p in tg.explainer.named_parameters()}
    aux_c = tc(batch, draws, inputs)
    aux_g = tg(to_device(batch, dev), to_device(draws, dev),
               to_device(inputs, dev))
    torch.cuda.synchronize()
    loss_c, loss_g = aux_c["loss"].item(), aux_g["loss"].item()
    if not abs(loss_g - loss_c) <= 1e-4 * abs(loss_c):
        raise AssertionError(f"explainer loss {loss_g} on the card, {loss_c} "
                             f"on the CPU")
    worst_g, worst_p, worst_r, unsettled, apart = 0.0, 0.0, 0.0, 0, 0.0
    params_c = dict(tc.explainer.named_parameters())
    for name, p in tg.explainer.named_parameters():
        pc = params_c[name]
        if pc.grad is None:                  # the enhance head (aff_*)
            if p.grad is not None:
                raise AssertionError(f"{name}: a gradient on the card only")
            continue
        g_c, g_g = pc.grad, p.grad.cpu()
        top = g_c.abs().max().item()
        torch.testing.assert_close(g_g, g_c, rtol=1e-3, atol=1e-4 * top,
                                   msg=lambda m: f"{name} grad: {m}")
        worst_g = max(worst_g, (g_g - g_c).abs().max().item() / max(top,
                                                                    1e-30))
        settled = (g_c.abs() >= 1e-4 * top) & (g_c.abs() >= 1e-5)
        unsettled += int((~settled).sum())
        diff = (p.detach().cpu() - pc.detach()).abs()
        apart = max(apart, diff.max().item())
        before, state = start[name]
        worst_r = max(worst_r, hold_adam_step(p, before, g_g, state, LR,
                                              f"[card] {name}"))
        torch.testing.assert_close(p.detach().cpu()[settled],
                                   pc.detach()[settled], rtol=1e-5,
                                   atol=1e-6,
                                   msg=lambda m: f"{name} param: {m}")
        worst_p = max(worst_p, diff[settled].max().item()
                      if settled.any() else 0.0)
    say(f"  train step: loss {loss_g:.7f} card, {loss_c:.7f} CPU; worst "
        f"gradient error {worst_g:.3e} of its tensor's largest; worst settled "
        f"param error after Adam {worst_p:.3e}; every card param within "
        f"{worst_r:.3e} of Adam replayed in float64 with the card's own "
        f"gradient ({unsettled} round-off-gradient entries, the two sides' "
        f"params at most {apart:.3e} apart)")


def check_explainer_against_cpu(ds, ckpt_dir, dev, base_type="tgn",
                                data=DATA_NAME, logit_atol=1e-5):
    """One explainer train step (batch 100, dropout 0.1, Beta sampling) on
    the card and on the CPU from the same checkpoints and the same draws
    (the gamma draws injected), the base at float32: loss rtol 1e-4;
    gradients rtol 1e-3, atol 1e-4 of each tensor's largest; params after
    Adam rtol 1e-5, atol 1e-6 where the gradient is settled, within lr
    elsewhere. Settled: at least 1e-4 of its tensor's largest and at least
    1e-5 (a thousand times Adam's eps: there the first step,
    lr * g / (|g| + eps), moves by under 1e-9 for a gradient error of
    1e-3; the explainer's smallest tensors' gradients are about 1e-4).
    Then one eval step: the explained logits and, from the same keep
    masks, the 16-ratio sweep's logits rtol 2e-4, atol ``logit_atol`` (a
    GraphMixer's keep masks over its n hop-0 edges)."""
    import torch
    from tempme_tpu_torch.train import loops
    from tempme_tpu_torch.train import temp_exp_main as X
    cpu = torch.device("cpu")
    tc, ec = explainer_steps_on(cpu, ds, ckpt_dir, torch.float32, base_type,
                                data)
    tg, eg = explainer_steps_on(dev, ds, ckpt_dir, torch.float32, base_type,
                                data)
    batch = loops.Batch(*(x[0] for x in loops.stack_batches(
        ds.train, EXPLAIN_BATCH, True, SEED + 1, cpu)))
    gen = torch.Generator(device=cpu)
    gen.manual_seed(SEED + 5)
    compare_explainer_train_steps(tc, tg, batch, explainer_draws(tc, gen),
                                  dev)

    ebatch = next(loops.iter_batches(ds.test, EXPLAIN_BATCH, False, cpu))
    edraws = ec.draw(gen, EXPLAIN_BATCH)
    with torch.no_grad():
        fc = ec._forward(ebatch, edraws, training=False)
        fg = eg._forward(to_device(ebatch, dev), to_device(edraws, dev),
                         training=False)
        for key in ("pos", "neg"):
            torch.testing.assert_close(fg[key].cpu(), fc[key], rtol=2e-4,
                                       atol=logit_atol)
        hops = len(fc["explanation"])        # a GraphMixer's: hop 0 alone
        keeps = X.keep_masks_for_ratios(fc["explanation"], ec.ratios,
                                        N_DEGREE, hops)
        own = X.keep_masks_for_ratios(fg["explanation"], eg.ratios, N_DEGREE,
                                      hops)
        flips = sum(int((a.cpu() != b).sum()) for sa, sb in zip(own, keeps)
                    for a, b in zip(sa, sb))
        args = (ebatch.src, ebatch.dst, fc["bgd"], ebatch.ts, *fc["subs"])
        pos_c, neg_c = ratio_sweep(ec, args, keeps)
        pos_g, neg_g = ratio_sweep(eg, to_device(args, dev),
                                   [[k.to(dev) for k in side]
                                    for side in keeps])
    torch.cuda.synchronize()
    if pos_g.shape != (16, EXPLAIN_BATCH):
        raise AssertionError(f"the ratio sweep's shape {pos_g.shape}")
    for a, b in ((pos_g, pos_c), (neg_g, neg_c)):
        torch.testing.assert_close(a.cpu(), b, rtol=2e-4, atol=logit_atol)
    err = max((pos_g.cpu() - pos_c).abs().max().item(),
              (neg_g.cpu() - neg_c).abs().max().item())
    err_x = max((fg[k].cpu() - fc[k]).abs().max().item()
                for k in ("pos", "neg"))
    say(f"  eval step: explained logits max abs err {err_x:.3e}; 16-ratio "
        f"sweep pos_r, neg_r max abs err {err:.3e} (rtol 2e-4, atol "
        f"{logit_atol:g}); the card's own keep masks differ from the "
        f"CPU's in {flips} of {sum(k.numel() for s in keeps for k in s)} "
        f"entries (near-ties of the importance ranking)")


def ratio_sweep(step, args, keeps):
    """The base's ``ratio_contrast`` under the keep masks ``keeps``, as the
    explainer's eval step calls it (a GraphMixer's hop 0 alone, a TGN with
    its memory)."""
    model = step.base.model
    if step.base.base_type == "graphmixer":
        return model.ratio_contrast(step.feats, *args, *(k[0] for k in keeps))
    return model.ratio_contrast(step.feats, step.base.memory, *args, *keeps)


def profile_explainer(ds, ckpt_dir, dev, n_steps=20, base_type="tgn",
                      data=DATA_NAME):
    """20 explainer train steps at batch 100 as the driver runs them (a
    TGN base at bf16, draws and gamma from a generator)."""
    import torch
    from tempme_tpu_torch.train import loops
    step, _ = explainer_steps_on(dev, ds, ckpt_dir, torch.bfloat16,
                                 base_type, data)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 13)
    batches = loops.stack_batches(ds.train, EXPLAIN_BATCH, True, SEED + 3,
                                  dev)
    work = [loops.Batch(*(x[i] for x in batches)) for i in range(n_steps)]

    def run(i):
        step(work[i], step.draw(gen, EXPLAIN_BATCH))
    run(0)                                   # warm up off the window
    profile_steps(run, n_steps)


# ---------------------------------------------------------------------------
# The first CUT_EVENTS events of the wikipedia-shaped stream: the cut of the
# explainer, TGAT, GraphMixer, enhance, cache and pipeline phases (a cut of
# scale, not of width). [explain] explains the TGN of [train] over it (its
# whole-stream epoch, 911 train and 474 eval steps, left the script no
# room); the 30,000-event cut took the script past its time limit on a slow
# host with the TGAT phases, and left no room for [dp-explain] and
# [dp-enhance] with the rest
CUT_EVENTS = 15_000
CUT_DATA = "wikishape15k"
EXPLAIN_DATA = CUT_DATA
# TGAT (3 layers, 2 heads, n_degree 20, width 172: d_k ceil(516 / 2) = 258)
# on the same cut (268 train and 142 eval steps at batch 32)
TGAT_EVENTS = CUT_EVENTS
TGAT_DATA = CUT_DATA
TGAT_BATCH = 32                      # the deep-TGAT batch rule's (not passed)
TGAT_REF_BATCH = 8                   # the card-vs-CPU train step's batch
TGAT_CKPT_STEP = 200                 # [tgat-train]'s mid-epoch checkpoint
TGAT_EXPLAIN_RESUME_STEP = 50
# launches per step: a train step samples 3 sides x 3 hops, embeds 4 times
# (src twice, tgt, bgd) through 3 + 2 + 1 (layer, level) blocks in the
# training form, recomputes each block in the backward (checkpointed
# blocks) and runs each block's backward; an eval step embeds 4 times in
# the eval form
TGAT_PER_STEP = {
    "train": dict(sample_rows=9, attend=0, attend_drop=48, attend_bwd=24),
    "eval": dict(sample_rows=9, attend=24, attend_drop=0, attend_bwd=0)}
# the explainer on the 3-layer TGAT: the base labels (24 attend) and runs
# again explained (24), and the 5 blocks a call whose output the explain
# weights reach (levels 0 and 1) are recomputed and differentiated (20
# each); an eval step adds the sweep's 3 blocks of layers 1-2 a side in 4
# chunks of 4 ratios (36); the null model samples 2 hops as for the TGN
TGAT_EXPLAIN_PER_STEP = {
    "train": dict(sample_rows=9, sample_union=3, sample_masked=3,
                  walk_to_edge=6, walk_to_edge_bwd=6, attend=68,
                  attend_drop=0, attend_bwd=20),
    "eval": dict(sample_rows=9, sample_union=3, sample_masked=3,
                 walk_to_edge=6, walk_to_edge_bwd=0, attend=84,
                 attend_drop=0, attend_bwd=0),
    "null": EXPLAIN_PER_STEP["null"]}
USLEGIS_TGAT = "params/tgnn/tgat_uslegis_sampled.msgpack"


def tgat_argv(ds_dir, out, *extra):
    """``learn_base`` at its defaults (TGAT, 3 layers, the deep-TGAT batch
    of 32, dropout 0.1, Adam lr 1e-3) on the cut stream, one epoch."""
    return ["--data", TGAT_DATA, "--data_dir", ds_dir,
            "--n_degree", str(N_DEGREE), "--n_epoch", "1",
            "--seed", str(SEED),
            "--out_dir", os.path.join(out, "params", "tgnn"),
            "--log_dir", os.path.join(out, "tb"),
            "--results_dir", os.path.join(out, "results"), *extra]


def tgat_train(ds, ds_dir, out, torch):
    """One epoch of ``learn_base.main --base_type tgat`` (its defaults) at
    full width on the card; the run also writes a checkpoint at step
    ``TGAT_CKPT_STEP``, copied as the state of a run stopped right there
    ([tgat-resume] resumes it). Returns (launches, steps, numbers,
    snapshot)."""
    return base_train(ds, ds_dir, out, torch, "tgat", tgat_argv,
                      TGAT_PER_STEP, TGAT_BATCH, TGAT_CKPT_STEP, TGAT_DATA,
                      layers=3)


def base_train(ds, ds_dir, out, torch, base_type, argv_of, per_step, batch,
               ckpt_step, data, layers):
    """One epoch of ``learn_base.main`` on a stateless base (``argv_of``
    gives its flags) at full width on the card, with ``per_step`` launches
    of each kernel per train and eval step; the run also writes a
    checkpoint at step ``ckpt_step``, copied as the state of a run stopped
    right there. Returns (launches, steps, numbers, snapshot)."""
    import math
    import shutil
    from tempme_tpu_torch.ops.kernels.attend import (attend, attend_bwd,
                                                     attend_drop)
    from tempme_tpu_torch.ops.kernels.sample_rows import sample_rows
    from tempme_tpu_torch.train import learn_base
    kernels = {"sample_rows": sample_rows, "attend": attend,
               "attend_drop": attend_drop, "attend_bwd": attend_bwd}
    train_steps = len(ds.train) // batch
    eval_steps = math.ceil(len(ds.val) / batch) + math.ceil(
        len(ds.test) / batch)
    want = {k: per_step["train"][k] * train_steps
            + per_step["eval"][k] * eval_steps for k in kernels}
    save = learn_base.save_checkpoint
    snapshot = os.path.join(out, "stopped.train_state")

    def snapshotting_save(path, blob, meta=None):
        save(path, blob, meta=meta)
        if meta and meta.get("step") == ckpt_step:
            shutil.copy(path, snapshot)
            shutil.copy(path + ".json", snapshot + ".json")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in kernels.values():
        f.launches = 0
    learn_base.save_checkpoint = snapshotting_save
    printed = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            test_ap = learn_base.main(argv_of(
                ds_dir, out, "--ckpt_every_steps", str(ckpt_step)))
    finally:
        learn_base.save_checkpoint = save
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: f.launches for name, f in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    for line in printed.getvalue().splitlines():
        say(f"    | {line}")
    if f"model={base_type}" not in printed.getvalue() or \
            f"layers={layers} bs={batch}" not in printed.getvalue():
        raise AssertionError(f"the flags did not give a {base_type} of "
                             f"{layers} layers at batch {batch}")
    say(f"  launches on the {base_type} training path: {launches} for "
        f"{train_steps} train and {eval_steps} eval steps; per step "
        f"{per_step}")
    check_launches(launches, want)
    tags = read_metrics(out)
    losses = tags["Train/step_loss"]
    if len(losses) != train_steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"a {base_type} train loss is missing or not "
                             "finite")
    tenth = max(1, train_steps // 10)
    first, last = (sum(x) / len(x) for x in (losses[:tenth],
                                              losses[-tenth:]))
    eps = tags["Train/events_per_s"][0]
    val_ap = tags["Val/ap"][0]
    for name, ap in (("val", val_ap), ("test", test_ap)):
        if not 0.0 <= ap <= 1.0:
            raise AssertionError(f"{base_type} {name} AP {ap} outside "
                                 "[0, 1]")
    if test_ap != tags["Test/ap"][0]:
        raise AssertionError("the returned test AP is not the logged one")
    params = os.path.join(out, "params", "tgnn", f"{base_type}_{data}.pt")
    for path in (params, params + ".json", params + ".train_state",
                 snapshot, os.path.join(out, "results",
                                        f"base_{base_type}_{data}.json")):
        if not os.path.exists(path):
            raise AssertionError(f"missing {path}")
    with open(params + ".json") as f:
        meta = json.load(f)
    if (meta["node_dim"], meta["n_layer"], meta["n_degree"]) != (
            172, layers, N_DEGREE):
        raise AssertionError(f"{base_type} checkpoint meta {meta}")
    numbers = dict(train_ms_per_step=batch / eps * 1e3,
                   events_per_s=eps, loss_first_tenth=first,
                   loss_last_tenth=last, val_ap=val_ap, test_ap=test_ap,
                   peak_gib=peak / 2 ** 30, wall_s=wall,
                   train_steps=train_steps, eval_steps=eval_steps)
    say(f"  {train_steps} steps: {numbers['train_ms_per_step']:.3f} "
        f"ms/step, {eps:.1f} events/s (the driver's epoch clock); mean loss "
        f"first tenth {first:.6f}, last tenth {last:.6f}; val AP "
        f"{val_ap:.6f}, test AP {test_ap:.6f}; peak device memory "
        f"{peak / 2 ** 30:.3f} GiB; main() {wall:.2f} s with loading and "
        f"eval; checkpoint meta n_layer {meta['n_layer']}")
    if not last < first:
        raise AssertionError(f"the {base_type} loss did not fall over the "
                             "epoch")
    return launches, train_steps, numbers, snapshot


def tgat_resume(ds_dir, out, snapshot):
    """``--resume`` to the end of the epoch from the state [tgat-train]
    wrote at its checkpoint of step ``TGAT_CKPT_STEP`` (what a run stopped
    right after it leaves), in a fresh output directory: the same checks
    as [resume]."""
    base_resume(ds_dir, out, snapshot, "tgat", tgat_argv, TGAT_DATA,
                TGAT_CKPT_STEP)


def base_resume(ds_dir, out, snapshot, base_type, argv_of, data, ckpt_step):
    """``--resume`` of a stateless base to the end of the epoch from the
    state its training run wrote at its checkpoint of step ``ckpt_step``,
    in a fresh output directory: it resumes there and finishes the epoch.
    Returns the resumed run's output directory of checkpoints."""
    import shutil
    from tempme_tpu_torch.train import learn_base
    state = os.path.join(out, "params", "tgnn",
                         f"{base_type}_{data}.pt.train_state")
    os.makedirs(os.path.dirname(state))
    shutil.copy(snapshot, state)
    shutil.copy(snapshot + ".json", state + ".json")
    with open(state + ".json") as f:
        meta = json.load(f)
    if (meta["epoch"], meta["step"]) != (0, ckpt_step):
        raise AssertionError(f"mid-epoch checkpoint meta {meta}")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        ap = learn_base.main(argv_of(ds_dir, out, "--ckpt_every_steps",
                                     str(ckpt_step), "--resume"))
    for line in printed.getvalue().splitlines():
        say(f"    | {line}")
    if f"at epoch 0 step {ckpt_step}" not in printed.getvalue():
        raise AssertionError(f"the run did not resume at step {ckpt_step}")
    with open(state + ".json") as f:
        meta = json.load(f)
    if meta["epoch"] != 0 or "step" in meta or not 0.0 <= ap <= 1.0:
        raise AssertionError(f"the resumed run did not finish: {meta}")
    return os.path.dirname(state)


def eval_only(argv, results, what):
    """``learn_base --eval_only`` on a trained stateless base: the test AP,
    AUC and accuracy its training run wrote to ``results``, exactly."""
    from tempme_tpu_torch.train import learn_base
    with open(results) as f:
        saved = json.load(f)
    with contextlib.redirect_stdout(io.StringIO()):
        test = learn_base.main(argv + ["--eval_only"])
    if any(test[k] != saved[k] for k in ("ap", "auc", "acc")):
        raise AssertionError(f"{what} --eval_only gave {test}, its training "
                             f"run wrote {saved}")
    say(f"  {what}: test AP {test['ap']:.6f}, AUC {test['auc']:.6f}, acc "
        f"{test['acc']:.6f}, equal to what its training run wrote")


def tgn_eval_only(ds_dir, out, dev):
    """``learn_base --eval_only`` on the TGN of [train] scores test from
    the checkpoint's train-side memory, with no val pass first (the JAX
    package's protocol): ``check_tgn_eval_only``. The training run's own
    test numbers (its memory carried through val first) are printed beside
    them."""
    from tempme_tpu_torch.data.events import load_dataset
    with open(os.path.join(out, "results",
                           f"base_tgn_{DATA_NAME}.json")) as f:
        after_val = json.load(f)             # --eval_only rewrites it
    check_tgn_eval_only(train_argv(ds_dir, out),
                        os.path.join(out, "params", "tgnn",
                                     f"tgn_{DATA_NAME}.pt"),
                        load_dataset(DATA_NAME, ds_dir), dev, "TGN")
    say(f"  (the training run, its memory through val first: AP "
        f"{after_val['ap']:.6f})")


def check_tgn_eval_only(argv, params, ds, dev, what):
    """``--eval_only`` on a TGN: its test AP, AUC and accuracy equal
    ``evaluate_tgn`` run here on the test split from the memory the
    checkpoint ``params`` saved, exactly."""
    import torch
    from tempme_tpu_torch.data.events import RandEdgeSampler
    from tempme_tpu_torch.data.graph import build_temporal_graph
    from tempme_tpu_torch.models.common import Features
    from tempme_tpu_torch.train import learn_base
    from tempme_tpu_torch.train.base_loader import load_base
    from tempme_tpu_torch.train.learn_tgn import (evaluate_tgn,
                                                  make_tgn_eval_step)
    with contextlib.redirect_stdout(io.StringIO()):
        test = learn_base.main(argv + ["--eval_only"])
    base = load_base(params, device=dev)
    dst = RandEdgeSampler([ds.train.src, ds.val.src, ds.test.src],
                          [ds.train.dst, ds.val.dst, ds.test.dst]).dst_list
    step = make_tgn_eval_step(
        base.model, build_temporal_graph(ds.full, ds.full.num_nodes,
                                         ds.full.num_edges, device=dev),
        Features(torch.from_numpy(ds.node_feat).to(dev),
                 torch.from_numpy(ds.edge_feat).to(dev)),
        torch.from_numpy(dst).to(dev), N_DEGREE)
    want, _ = evaluate_tgn(step, base.memory, ds.test, BATCH)
    if any(test[k] != want[k] for k in ("ap", "auc", "acc")):
        raise AssertionError(f"{what} --eval_only gave {test}; evaluate_tgn "
                             f"from the saved memory gives {want}")
    say(f"  {what}: test AP {test['ap']:.6f}, AUC {test['auc']:.6f}, acc "
        f"{test['acc']:.6f}, equal to evaluate_tgn from the checkpoint's "
        f"memory")


def tgat_steps_on(dev, ds, blob, compute_dtype):
    """The TGAT train step of the checkpoint ``blob`` on ``dev`` with the
    projections in ``compute_dtype``: model (checkpointed blocks, as the
    driver builds it) and Adam state loaded, train graph and features on
    ``dev``."""
    import torch
    from tempme_tpu_torch.data.events import RandEdgeSampler
    from tempme_tpu_torch.data.graph import build_temporal_graph
    from tempme_tpu_torch.models.common import Features
    from tempme_tpu_torch.models.tgat import TGAT
    from tempme_tpu_torch.train import loops
    g = build_temporal_graph(ds.train, ds.full.num_nodes, ds.full.num_edges,
                             device=dev)
    feats = Features(torch.from_numpy(ds.node_feat).to(dev),
                     torch.from_numpy(ds.edge_feat).to(dev))
    model = TGAT(ds.node_feat.shape[1], ds.edge_feat.shape[1], num_layers=3,
                 n_head=2, dropout=DROPOUT, remat=True, device=dev,
                 compute_dtype=compute_dtype)
    model.load_state_dict(blob["params"])
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    opt.load_state_dict(copy.deepcopy(blob["opt_state"]))
    dst = RandEdgeSampler([ds.train.src], [ds.train.dst]).dst_list
    return loops.make_base_train_step(model, g, feats,
                                      torch.from_numpy(dst).to(dev), 3,
                                      N_DEGREE, opt)


def compare_train_steps(step_c, aux_c, step_g, aux_g, what, grad_atol=1e-4,
                        exact_zero=(), looser=(), fresh_adam=False,
                        reference=None):
    """Loss rtol 1e-4; gradients rtol 1e-3, atol ``grad_atol`` (1e-4 by
    default) of each tensor's largest; params after Adam rtol 1e-5, atol
    1e-6 where the gradient is settled (at least 1e-4 of its tensor's
    largest), within lr elsewhere (Adam turns round-off gradients into
    steps of up to lr). A parameter whose name ends in one of
    ``exact_zero`` has a gradient that is zero in exact arithmetic (an
    attention's key bias, which the softmax cancels): its round-off is held
    to ``grad_atol`` of the model's largest gradient, none of it is
    settled, and each side may step it by up to lr either way. ``looser``
    pairs a part of a name with its own ``grad_atol``. With ``fresh_adam``
    (the step is Adam's first) the unsettled entries are held within 2 lr:
    the first step moves an entry by lr g / (|g| + eps), so a round-off
    gradient above eps whose sign differs between the sides parts them by
    up to 2 lr. A parameter that no gradient reaches on either side (a
    TGN's time encoder where its embedding reads no support) must come out
    unchanged on both. ``reference``: ``{name: (gradient, param, state)}``,
    the same step's gradient on the CPU in float64 and the card's
    parameter and Adam state before its step; a gradient outside the
    tolerance above then passes if the card's largest distance from the
    float64 one is at most ``CONDITIONED_CAP`` times the CPU float32's
    (``conditioned``), and that parameter after Adam is held, in place of
    the CPU's settled entries (the two float32 gradients may differ in
    sign there), to Adam replayed in float64 with the card's own gradient
    (``utils/optim.py``, rtol 1e-5, atol 1e-6), still within the lr bound
    above. The tensors that pass so are printed with their ratios."""
    import torch
    from tempme_tpu_torch.utils.optim import hold_adam_step
    loss_c, loss_g = aux_c["loss"].item(), aux_g["loss"].item()
    if not abs(loss_g - loss_c) <= 1e-4 * abs(loss_c):
        raise AssertionError(f"{what}: loss {loss_g} on the card, {loss_c} "
                             f"on the CPU")
    worst_g, worst_p, worst_r, unsettled, by_f64 = 0.0, 0.0, 0.0, 0, {}
    params_c = dict(step_c.model.named_parameters())
    model_top = max(p.grad.abs().max().item() for p in params_c.values()
                    if p.grad is not None)
    for name, p in step_g.model.named_parameters():
        pc = params_c[name]
        if p.grad is None or pc.grad is None:
            if p.grad is not None or pc.grad is not None or \
                    not torch.equal(p.detach().cpu(), pc.detach()):
                raise AssertionError(f"{what}: {name} has a gradient on "
                                     f"one side only, or moved without one")
            continue
        g_c, g_g = pc.grad, p.grad.cpu()
        zero = name.endswith(exact_zero) if exact_zero else False
        top = model_top if zero else g_c.abs().max().item()
        atol = next((a for part, a in looser if part in name), grad_atol)
        try:
            torch.testing.assert_close(g_g, g_c, rtol=0.0 if zero else 1e-3,
                                       atol=atol * top,
                                       msg=lambda m: f"{name} grad: {m}")
        except AssertionError:
            if reference is None:
                raise
            by_f64[name] = conditioned(g_g, g_c, reference[name][0], name)
        else:
            worst_g = max(worst_g, (g_g - g_c).abs().max().item() / max(
                top, 1e-30))
        settled = g_c.abs() >= 1e-4 * top
        if zero:
            settled &= False
        unsettled += int((~settled).sum())
        diff = (p.detach().cpu() - pc.detach()).abs()
        if diff.max().item() > LR * (2.002 if zero or fresh_adam
                                     else 1.001):
            raise AssertionError(f"{name}: params after Adam differ by "
                                 f"{diff.max().item()}")
        if name in by_f64:
            _, before, state = reference[name]
            worst_r = max(worst_r, hold_adam_step(p, before, g_g, state, LR,
                                                  f"[card] {name}"))
            continue
        torch.testing.assert_close(p.detach().cpu()[settled],
                                   pc.detach()[settled], rtol=1e-5,
                                   atol=1e-6,
                                   msg=lambda m: f"{name} param: {m}")
        worst_p = max(worst_p, diff[settled].max().item()
                      if settled.any() else 0.0)
    say(f"  {what}: loss {loss_g:.7f} card, {loss_c:.7f} CPU; worst "
        f"gradient error {worst_g:.3e} of its tensor's largest; worst "
        f"settled param error after Adam {worst_p:.3e} ({unsettled} "
        f"round-off-gradient entries held to lr)")
    if by_f64:
        say(f"  {what}: {len(by_f64)} gradients passed by the float64 "
            f"clause (the card's largest distance from float64 over the "
            f"CPU float32's, cap {CONDITIONED_CAP}): " + ", ".join(
                f"{k} {r:.3f}" for k, r in by_f64.items()) +
            f"; their params within {worst_r:.3e} of Adam replayed in "
            f"float64 with the card's own gradient")
    return by_f64


# a gradient outside its tolerance passes if the card sits at most this many
# times as far from the float64 gradient as the CPU's float32 does: the
# round-off of an ill-conditioned batch, which both float32 devices share
# (the TGAT enhance step of the 15,000-event cut, whose walks are a quarter
# padding, gave at most 1.51 on an H100: chip_probes/probe_enh_tgat.py)
CONDITIONED_CAP = 2.0


def conditioned(g_g, g_c, g64, name) -> float:
    """The card's largest distance from the float64 gradient ``g64`` over
    the CPU float32's (both absolute: the ratio is the same relative to
    ``g64``'s largest, and it also holds where ``g64`` is zero everywhere);
    raises above ``CONDITIONED_CAP``."""
    e_card = (g_g.double() - g64).abs().max().item()
    e_cpu = (g_c.double() - g64).abs().max().item()
    ratio = e_card / e_cpu if e_cpu > 0 else (0.0 if e_card == 0 else
                                              float("inf"))
    if not ratio <= CONDITIONED_CAP:
        raise AssertionError(
            f"{name} grad: the card's distance from float64 {e_card:.3e} is "
            f"{ratio:.3f} times the CPU float32's {e_cpu:.3e} (cap "
            f"{CONDITIONED_CAP})")
    return ratio


def check_tgat_train_against_cpu(ds, out, dev):
    """One TGAT train step at full width (d_k 258, batch
    ``TGAT_REF_BATCH``) on the card and on the CPU from the trained
    checkpoint at float32, with the same draws (dropout 0.1 included)."""
    import torch
    from tempme_tpu_torch.train import loops
    from tempme_tpu_torch.utils.checkpoint import load_checkpoint
    blob, _ = load_checkpoint(os.path.join(
        out, "params", "tgnn", f"tgat_{TGAT_DATA}.pt.train_state"),
        map_location="cpu")
    cpu = torch.device("cpu")
    step_c = tgat_steps_on(cpu, ds, blob, torch.float32)
    step_g = tgat_steps_on(dev, ds, blob, torch.float32)
    if step_g.model.attn_layers[0].attn.d_k != 258:
        raise AssertionError("the TGAT's d_k is not 258")
    batch = loops.Batch(*(x[0] for x in loops.stack_batches(
        ds.train, TGAT_REF_BATCH, True, SEED + 1, cpu)))
    gen = torch.Generator(device=cpu)
    gen.manual_seed(SEED + 3)
    draws = step_c.draw(gen, TGAT_REF_BATCH)
    aux_c = step_c(batch, draws)
    aux_g = step_g(to_device(batch, dev), to_device(draws, dev))
    torch.cuda.synchronize()
    compare_train_steps(step_c, aux_c, step_g, aux_g, "TGAT train step")


def check_uslegis_tgat(ds, dev):
    """The committed uslegis TGAT (3 layers, node 172, edge 1: d_k 173,
    ``fc`` 346 -> 345; read by the port's own msgpack reader) scores 8
    events of the cut stream (edge features cut to width 1) over supports
    of its ``n_degree`` 30 (30 + 900 + 27,000 events a side), on the card
    and on the CPU with the same supports: at float32 rtol 2e-4, atol 1e-5;
    at bf16, the default, rtol 5e-2, atol 5e-2 (each side rounds its
    projections to bf16 after float32 sums taken in another order, a bf16
    ulp is 4e-3, and the differences pass through three layers)."""
    import torch
    from tempme_tpu_torch.data.events import RandEdgeSampler
    from tempme_tpu_torch.data.graph import build_temporal_graph
    from tempme_tpu_torch.models.common import Features
    from tempme_tpu_torch.models.tgat import TGAT
    from tempme_tpu_torch.train import loops
    from tempme_tpu_torch.utils.checkpoint import load_meta
    from tempme_tpu_torch.utils.convert import (flax_to_state_dict,
                                                read_flax_msgpack)
    path = os.path.join(ROOT, USLEGIS_TGAT)
    meta = load_meta(path)
    state = flax_to_state_dict(read_flax_msgpack(path))
    cpu = torch.device("cpu")
    n, b = int(meta["n_degree"]), 8
    g = build_temporal_graph(ds.full, ds.full.num_nodes, ds.full.num_edges,
                             device=cpu)
    feats = Features(torch.from_numpy(ds.node_feat),
                     torch.from_numpy(ds.edge_feat[:, :meta["edge_dim"]]
                                      .copy()))
    dst = torch.from_numpy(RandEdgeSampler([ds.test.src],
                                           [ds.test.dst]).dst_list)
    batch = next(loops.iter_batches(ds.test, b, False, cpu))
    gen = torch.Generator(device=cpu)
    gen.manual_seed(SEED + 17)
    draws = loops.draw_support(gen, b, meta["n_layer"], n, dst.shape[0], cpu)
    bgd, *subs = loops.sample_support(g, batch, dst, meta["n_layer"], n,
                                      draws, use_eidx=False)
    errs = {}
    for dtype, rtol, atol in ((torch.float32, 2e-4, 1e-5),
                              (torch.bfloat16, 5e-2, 5e-2)):
        out = []
        for d in (cpu, dev):
            model = TGAT(meta["node_dim"], meta["edge_dim"],
                         num_layers=meta["n_layer"], n_head=meta["n_head"],
                         dropout=0.0, device=d, compute_dtype=dtype)
            model.load_state_dict(state)
            if model.attn_layers[0].attn.d_k != 173:
                raise AssertionError("the uslegis TGAT's d_k is not 173")
            with torch.no_grad():
                out.append(model.contrast(
                    to_device(feats, d), *(x.to(d) for x in (
                        batch.src, batch.dst, bgd, batch.ts)),
                    *(to_device(sub, d) for sub in subs)))
        torch.cuda.synchronize()
        for a, c in zip(out[1], out[0]):
            torch.testing.assert_close(a.cpu(), c, rtol=rtol, atol=atol)
        errs[str(dtype)[6:]] = max((a.cpu() - c).abs().max().item()
                                   for a, c in zip(out[1], out[0]))
    say(f"  uslegis TGAT contrast (batch {b}, n {n}, 3 hops): card against "
        f"CPU max abs err {errs['float32']:.3e} at float32 (rtol 2e-4, atol "
        f"1e-5), {errs['bfloat16']:.3e} at bf16 (rtol 5e-2, atol 5e-2)")


def profile_tgat_training(ds, out, dev, n_steps=20):
    """20 TGAT train steps at batch 32 from the checkpoint's state, the
    projections in bf16 as the driver runs them."""
    import torch
    from tempme_tpu_torch.train import loops
    from tempme_tpu_torch.utils.checkpoint import load_checkpoint
    blob, _ = load_checkpoint(os.path.join(
        out, "params", "tgnn", f"tgat_{TGAT_DATA}.pt.train_state"),
        map_location="cpu")
    step = tgat_steps_on(dev, ds, blob, torch.bfloat16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 19)
    batches = loops.stack_batches(ds.train, TGAT_BATCH, True, SEED + 4, dev)
    work = [(loops.Batch(*(x[i] for x in batches)),
             step.draw(gen, TGAT_BATCH)) for i in range(n_steps)]

    def run(i):
        step(*work[i])
    run(0)                                   # warm up off the window
    profile_steps(run, n_steps)


def check_tgat_kernels(g, torch, dev):
    """The kernels at the TGAT paths' shapes on the stream's graph:
    ``sample_rows`` down three hops of batch 32 (Q 32, 640, 12,800, the
    lower two cut at the picked edges) and at the explainer's hop 3 (Q
    40,000 from batch 100), bitwise; ``attend`` (h 2, n 20, d_k 258) at the
    pyramid's rows m 32, 640, 12,800 (training and eval), 40,000 (the
    explainer's hop 2) and 8,000 (the sweep's 4 ratios x 100 x 20) and at
    d_k 173 (the uslegis TGAT) at m 8,000, float32 and bf16;
    ``attend_drop`` and ``attend_bwd``'s training form at m 12,800 and the
    explain weight's gradient at m 2,000 (the explainer's hop 1), bf16;
    and C3's sizes: ``sample_rows`` at n 3,073 and 4,096 and the
    ``walk_to_edge`` forward at 4,097 and 8,192 slots a row (its scan
    path), bitwise. Returns (rows, errors)."""
    import torch.nn.functional as F
    from tempme_tpu_torch.ops.kernels.attend import (
        attend, attend_bwd, attend_bwd_plain, attend_drop, attend_drop_plain,
        attend_plain)
    from tempme_tpu_torch.ops.kernels.sample_rows import (sample_rows,
                                                          sample_rows_plain)
    from tempme_tpu_torch.ops.kernels.walk_to_edge import (
        walk_to_edge_count_plain, walk_to_edge_fwd, walk_to_edge_plain)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 29)
    rows, errs = {}, {}

    def timed(name, kernel, plain, nbytes, ops, ops_per_s=H100_F32_OPS_PER_S,
              library=None):
        ms, host = time_ms(kernel)
        plain_ms, _ = time_ms(plain)
        lib = time_ms(library)[0] if library is not None else None
        least, by = bound(nbytes, ops, ops_per_s)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=least,
                          bound_by=by, library_ms=lib)
        say(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
            + (f", sdpa {lib:.4f} ms" if lib is not None else "")
            + f", bound {least:.5f} ms ({by}); eager call from the host "
            f"{host:.4f} ms")

    # sample_rows down the pyramid: hop 0 at the batch time, then edge cuts
    def hop_chain(b):
        nodes = torch.randint(1, g.num_nodes, (b,), generator=gen,
                              device=dev, dtype=torch.int32)
        times = torch.rand((b,), generator=gen, device=dev) * 1e6
        args, eids = [], None
        for _ in range(3):
            u = torch.rand((nodes.shape[0], N_DEGREE), generator=gen,
                           device=dev)
            args.append((nodes, times, u, eids))
            got = sample_rows(g, nodes, times, u, eids)
            want = sample_rows_plain(g, nodes, times, u, eids)
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"sample_rows differs from its plain "
                                     f"version at Q {nodes.shape[0]}")
            nodes, eids, times = (x.reshape(-1).contiguous() for x in got)
        return args
    train_hops, explain_hops = hop_chain(TGAT_BATCH), hop_chain(100)
    for name, args in (("tgat hop2 Q=12800", train_hops[2]),
                       ("tgat explain hop2 Q=40000", explain_hops[2])):
        q, n = args[2].shape
        timed(f"sample_rows {name}", lambda: sample_rows(g, *args),
              lambda: sample_rows_plain(g, *args),
              sample_rows_bytes(g, *args), q * n * (2 * n + 4),
              H100_INT32_OPS_PER_S)
    errs["sample_rows"] = 0.0

    h, n = 2, N_DEGREE
    fwd_err = bwd_err = 0.0
    for dk, m, dtype in [(258, m, d) for m in (32, 640, 8000, 12800, 40000)
                         for d in (torch.float32, torch.bfloat16)] + [
            (173, 8000, torch.float32), (173, 8000, torch.bfloat16)]:
        scale = 1.0 / dk ** 0.5
        q = torch.randn((m, h, dk), generator=gen, device=dev).to(dtype)
        k = torch.randn((m, n, h, dk), generator=gen, device=dev).to(dtype)
        v = torch.randn((m, n, h, dk), generator=gen, device=dev).to(dtype)
        mask = torch.rand((m, n), generator=gen, device=dev) < 0.3
        mask[:3] = True
        ew = torch.rand((m, n), generator=gen, device=dev)
        u = torch.rand((m, h, n), generator=gen, device=dev)
        dout = torch.randn((m, h, dk), generator=gen, device=dev)
        # the plain version in float64, rounded to float32: at d_k 258 the
        # float32 plain version's own sums round in another order than the
        # kernel's (tests/test_torch_kernels_cuda.py)
        q64, k64, v64 = q.double(), k.double(), v.double()
        for got, want in (
                (attend(q, k, v, mask, ew, scale),
                 attend_plain(q64, k64, v64, mask, ew.double(), scale)),
                (attend_drop(q, k, v, mask, None, u, DROPOUT, scale),
                 attend_drop_plain(q64, k64, v64, mask, None, u.double(),
                                   DROPOUT, scale))):
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                b = b.float()
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
                fwd_err = max(fwd_err, (a - b).abs().max().item())
        del q64, k64, v64
        for mk, w, uu, rate, ew_grad in ((mask, None, u, DROPOUT, False),
                                         (mask, ew, None, 0.0, True)):
            got = attend_bwd(q, k, v, mk, w, uu, rate, scale, dout,
                             ew_grad=ew_grad)
            want = attend_bwd_plain(q, k, v, mk, w, uu, rate, scale, dout,
                                    ew_grad=ew_grad)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                if a is None:
                    continue
                tol = (dict(rtol=1e-2, atol=1e-4) if a.dtype == torch.bfloat16
                       else dict(rtol=1e-5, atol=1e-5))
                torch.testing.assert_close(a.float(), b.float(), **tol)
                if a.dtype == torch.float32:
                    bwd_err = max(bwd_err, (a - b).abs().max().item())
        if dtype != torch.bfloat16:
            continue
        elem = q.element_size()
        tag = f"m={m} dk={dk} bfloat16"
        if dk == 258:
            qs, ks, vs = (q[:, :, None, :], k.permute(0, 2, 1, 3),
                          v.permute(0, 2, 1, 3))
            bias = torch.zeros((m, 1, 1, n), device=dev,
                               dtype=dtype).masked_fill(
                mask[:, None, None, :], -1e10)
            timed(f"attend tgat {tag}",
                  lambda: attend(q, k, v, mask, ew, scale),
                  lambda: attend_plain(q, k, v, mask, ew, scale),
                  attend_bytes(m, h, n, dk, True, True, elem),
                  m * h * n * (4 * dk + 5),
                  library=lambda: F.scaled_dot_product_attention(
                      qs, ks, vs, attn_mask=bias))
        if dk == 258 and m == 12800:
            timed(f"attend_drop tgat {tag}",
                  lambda: attend_drop(q, k, v, mask, None, u, DROPOUT,
                                      scale),
                  lambda: attend_drop_plain(q, k, v, mask, None, u, DROPOUT,
                                            scale),
                  attend_drop_bytes(m, h, n, dk, True, False, elem),
                  m * h * n * (4 * dk + 6))
            timed(f"attend_bwd tgat {tag}",
                  lambda: attend_bwd(q, k, v, mask, None, u, DROPOUT, scale,
                                     dout),
                  lambda: attend_bwd_plain(q, k, v, mask, None, u, DROPOUT,
                                           scale, dout),
                  attend_bwd_bytes(m, h, n, dk, True, False, elem),
                  m * h * n * (8 * dk + 12))
    # the explain weight's gradient at the explainer's hop 1 (m 2,000)
    m, dk, dtype = 2000, 258, torch.bfloat16
    q = torch.randn((m, h, dk), generator=gen, device=dev).to(dtype)
    k = torch.randn((m, n, h, dk), generator=gen, device=dev).to(dtype)
    v = torch.randn((m, n, h, dk), generator=gen, device=dev).to(dtype)
    mask = torch.rand((m, n), generator=gen, device=dev) < 0.3
    ew = torch.rand((m, n), generator=gen, device=dev)
    dout = torch.randn((m, h, dk), generator=gen, device=dev)
    scale = 1.0 / dk ** 0.5
    timed(f"attend_bwd tgat explain m={m} dk={dk} bfloat16 ew",
          lambda: attend_bwd(q, k, v, mask, ew, None, 0.0, scale, dout,
                             ew_grad=True),
          lambda: attend_bwd_plain(q, k, v, mask, ew, None, 0.0, scale, dout,
                                   ew_grad=True),
          attend_bwd_bytes(m, h, n, dk, True, False, 2, True),
          m * h * n * (8 * dk + 12))
    errs["attend"], errs["attend_bwd"] = fwd_err, bwd_err
    say(f"  TGAT shapes: attend and attend_drop max abs err vs plain "
        f"{fwd_err:.3e} (the plain version in float64; rtol 1e-5, atol "
        f"1e-6); attend_bwd at float32 "
        f"{bwd_err:.3e} (rtol 1e-5, atol 1e-5; bf16 dq, dk, dv rtol 1e-2, "
        f"atol 1e-4)")

    # C3: rows above the old limits
    nodes = train_hops[1][0][:129].contiguous()
    times = train_hops[1][1][:129].contiguous()
    for big in (3073, 4096):
        u = torch.rand((129, big), generator=gen, device=dev)
        got = sample_rows(g, nodes, times, u)
        want = sample_rows_plain(g, nodes, times, u)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"sample_rows differs at n {big}")
    for s_len in (4097, 8192):
        ids = torch.randint(0, 5000, (20, s_len), generator=gen, device=dev,
                            dtype=torch.int32)
        imp = torch.rand((20, s_len), generator=gen, device=dev)
        tgt = torch.randint(0, 5000, (20, 400), generator=gen, device=dev,
                            dtype=torch.int32)
        out, cnt = walk_to_edge_fwd(ids, imp, tgt)
        ref = walk_to_edge_plain(ids, imp, tgt)
        ref_cnt = walk_to_edge_count_plain(ids, imp, tgt)
        torch.cuda.synchronize()
        if not (torch.equal(out, ref) and torch.equal(cnt, ref_cnt)):
            raise AssertionError(f"walk_to_edge differs at S {s_len}")
        if not (out > 0).any():
            raise AssertionError("walk_to_edge: no target matched at S "
                                 f"{s_len}")
        # the function's work, as for the table path (about 8 integer
        # operations a slot and a target), not the scan's B * T * S
        # compares
        timed(f"walk_to_edge scan path S={s_len} T=400",
              lambda: walk_to_edge_fwd(ids, imp, tgt),
              lambda: walk_to_edge_plain(ids, imp, tgt),
              20 * s_len * 8 + 20 * 400 * 12, 8 * 20 * (s_len + 400),
              H100_INT32_OPS_PER_S)
    say("  C3: sample_rows at n 3,073 and 4,096 and walk_to_edge at 4,097 "
        "and 8,192 slots a row equal to their plain versions bit for bit")
    return rows, errs


# ---------------------------------------------------------------------------
# GraphMixer (3 mixer blocks, 20 neighbours = tokens, width 172: token FFN
# int(0.5 * 20) = 10, channel FFN 4 * 172 = 688) on the stream's first
# CUT_EVENTS events (on all of it the script ran past its time budget): a
# cut of scale, not of width
MIXER_DATA = CUT_DATA
MIXER_BATCH = 256
MIXER_REF_BATCH = 64                 # the card-vs-CPU train step's batch
MIXER_CKPT_STEP = 20                 # [mixer-train]'s mid-epoch checkpoint
MIXER_EXPLAIN_RESUME_STEP = 50
# launches per step: a train or eval step samples 3 sides x 2 hops (the
# model reads hop 0); GraphMixer runs no attention
MIXER_PER_STEP = {
    "train": dict(sample_rows=6, attend=0, attend_drop=0, attend_bwd=0),
    "eval": dict(sample_rows=6, attend=0, attend_drop=0, attend_bwd=0)}
# the explainer on a GraphMixer carries the walk importance onto hop 0
# only (the JAX package computes hop 1 too and drops it): 3 sides a step
MIXER_EXPLAIN_PER_STEP = {
    "train": dict(sample_rows=6, sample_union=3, sample_masked=3,
                  walk_to_edge=3, walk_to_edge_bwd=3, attend=0,
                  attend_drop=0, attend_bwd=0),
    "eval": dict(sample_rows=6, sample_union=3, sample_masked=3,
                 walk_to_edge=3, walk_to_edge_bwd=0, attend=0,
                 attend_drop=0, attend_bwd=0),
    "null": EXPLAIN_PER_STEP["null"]}
USLEGIS_MIXER = "params/tgnn/graphmixer_uslegis_sampled.msgpack"


def mixer_argv(ds_dir, out, *extra):
    """``learn_base --base_type graphmixer`` at its defaults (3 mixer
    blocks, batch 256, dropout 0.1, Adam lr 1e-3), one epoch."""
    return ["--data", MIXER_DATA, "--data_dir", ds_dir,
            "--base_type", "graphmixer", "--n_degree", str(N_DEGREE),
            "--n_epoch", "1", "--seed", str(SEED),
            "--out_dir", os.path.join(out, "params", "tgnn"),
            "--log_dir", os.path.join(out, "tb"),
            "--results_dir", os.path.join(out, "results"), *extra]


def mixer_steps_on(dev, ds, blob):
    """The GraphMixer train step of the checkpoint ``blob`` on ``dev``:
    model and Adam state loaded, train graph and features on ``dev``."""
    import torch
    from tempme_tpu_torch.data.events import RandEdgeSampler
    from tempme_tpu_torch.data.graph import build_temporal_graph
    from tempme_tpu_torch.models.common import Features
    from tempme_tpu_torch.models.graphmixer import GraphMixer
    from tempme_tpu_torch.train import loops
    g = build_temporal_graph(ds.train, ds.full.num_nodes, ds.full.num_edges,
                             device=dev)
    feats = Features(torch.from_numpy(ds.node_feat).to(dev),
                     torch.from_numpy(ds.edge_feat).to(dev))
    model = GraphMixer(ds.node_feat.shape[1], ds.edge_feat.shape[1],
                       N_DEGREE, num_layers=3, dropout=DROPOUT, device=dev)
    model.load_state_dict(blob["params"])
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    opt.load_state_dict(copy.deepcopy(blob["opt_state"]))
    dst = RandEdgeSampler([ds.train.src], [ds.train.dst]).dst_list
    return loops.make_base_train_step(model, g, feats,
                                      torch.from_numpy(dst).to(dev), 2,
                                      N_DEGREE, opt)


def check_mixer_train_against_cpu(ds, out, dev):
    """One GraphMixer train step at full width (batch ``MIXER_REF_BATCH``)
    on the card and on the CPU from the trained checkpoint, float32 as the
    model always is, with the same draws (dropout 0.1 included). The
    gradients' atol is 5e-4 of each tensor's largest, not 1e-4: the
    backward runs through token LayerNorms over near-constant rows (padded
    slots all hold the projection's bias; the frozen time encoding's low
    frequencies give every token the same value), whose normaliser 1 /
    sqrt(var + 1e-5) scales float32 round-off by up to 316, as
    ``tests/test_torch_graphmixer.py`` finds against the JAX package."""
    import torch
    from tempme_tpu_torch.train import loops
    from tempme_tpu_torch.utils.checkpoint import load_checkpoint
    blob, _ = load_checkpoint(os.path.join(
        out, "params", "tgnn", f"graphmixer_{MIXER_DATA}.pt.train_state"),
        map_location="cpu")
    cpu = torch.device("cpu")
    step_c = mixer_steps_on(cpu, ds, blob)
    step_g = mixer_steps_on(dev, ds, blob)
    ffn = step_g.model.mixers[0]
    if (ffn.token_ffn.hidden, ffn.channel_ffn.hidden) != (10, 688):
        raise AssertionError("the GraphMixer's FFN widths are not 10, 688")
    batch = loops.Batch(*(x[0] for x in loops.stack_batches(
        ds.train, MIXER_REF_BATCH, True, SEED + 1, cpu)))
    gen = torch.Generator(device=cpu)
    gen.manual_seed(SEED + 3)
    draws = step_c.draw(gen, MIXER_REF_BATCH)
    aux_c = step_c(batch, draws)
    aux_g = step_g(to_device(batch, dev), to_device(draws, dev))
    torch.cuda.synchronize()
    compare_train_steps(step_c, aux_c, step_g, aux_g,
                        "GraphMixer train step", grad_atol=5e-4)


def check_uslegis_mixer(ds, dev):
    """The committed uslegis GraphMixer (read by the port's own msgpack
    reader: 3 blocks, 30 tokens, edge 1, so 1 channel; its meta says
    ``n_layer`` 2, the support depth the JAX driver writes there) scores 8
    events of the stream (edge features cut to width 1) over 2-hop supports
    of its ``n_degree`` 30, on the card and on the CPU with the same
    supports, at float32: rtol 2e-4, atol 1e-5."""
    import torch
    from tempme_tpu_torch.data.events import RandEdgeSampler
    from tempme_tpu_torch.data.graph import build_temporal_graph
    from tempme_tpu_torch.models.common import Features
    from tempme_tpu_torch.models.graphmixer import GraphMixer
    from tempme_tpu_torch.train import loops
    from tempme_tpu_torch.utils.checkpoint import load_meta
    from tempme_tpu_torch.utils.convert import (flax_to_state_dict,
                                                mixer_blocks,
                                                read_flax_msgpack)
    path = os.path.join(ROOT, USLEGIS_MIXER)
    meta = load_meta(path)
    state = flax_to_state_dict(read_flax_msgpack(path))
    blocks = mixer_blocks(state)
    if (blocks, meta["n_layer"]) != (3, 2):
        raise AssertionError(f"uslegis GraphMixer: {blocks} blocks, meta "
                             f"n_layer {meta['n_layer']}")
    cpu = torch.device("cpu")
    n, b = int(meta["n_degree"]), 8
    g = build_temporal_graph(ds.full, ds.full.num_nodes, ds.full.num_edges,
                             device=cpu)
    feats = Features(torch.from_numpy(ds.node_feat),
                     torch.from_numpy(ds.edge_feat[:, :meta["edge_dim"]]
                                      .copy()))
    dst = torch.from_numpy(RandEdgeSampler([ds.test.src],
                                           [ds.test.dst]).dst_list)
    batch = next(loops.iter_batches(ds.test, b, False, cpu))
    gen = torch.Generator(device=cpu)
    gen.manual_seed(SEED + 23)
    draws = loops.draw_support(gen, b, 2, n, dst.shape[0], cpu)
    bgd, *subs = loops.sample_support(g, batch, dst, 2, n, draws,
                                      use_eidx=False)
    out = []
    for d in (cpu, dev):
        model = GraphMixer(meta["node_dim"], meta["edge_dim"], n,
                           num_layers=blocks, dropout=0.0, device=d)
        model.load_state_dict(state)
        with torch.no_grad():
            out.append(model.contrast(
                to_device(feats, d), *(x.to(d) for x in (
                    batch.src, batch.dst, bgd, batch.ts)),
                *(to_device(sub, d) for sub in subs)))
    torch.cuda.synchronize()
    for a, c in zip(out[1], out[0]):
        torch.testing.assert_close(a.cpu(), c, rtol=2e-4, atol=1e-5)
    err = max((a.cpu() - c).abs().max().item()
              for a, c in zip(out[1], out[0]))
    say(f"  uslegis GraphMixer contrast (3 blocks, batch {b}, n {n}): card "
        f"against CPU max abs err {err:.3e} at float32 (rtol 2e-4, atol "
        f"1e-5)")


def profile_mixer_training(ds, out, dev, n_steps=20):
    """20 GraphMixer train steps at batch 256 from the checkpoint's
    state."""
    import torch
    from tempme_tpu_torch.train import loops
    from tempme_tpu_torch.utils.checkpoint import load_checkpoint
    blob, _ = load_checkpoint(os.path.join(
        out, "params", "tgnn", f"graphmixer_{MIXER_DATA}.pt.train_state"),
        map_location="cpu")
    step = mixer_steps_on(dev, ds, blob)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 29)
    batches = loops.stack_batches(ds.train, MIXER_BATCH, True, SEED + 6, dev)
    work = [(loops.Batch(*(x[i] for x in batches)),
             step.draw(gen, MIXER_BATCH)) for i in range(n_steps)]

    def run(i):
        step(*work[i])
    run(0)                                   # warm up off the window
    profile_steps(run, n_steps)


def graphmixer_phases(work, ds_dir, dsm, dev, torch):
    """[mixer-train], [mixer-resume], [eval-only], [mixer-reference],
    [mixer-explain] and [trace-mixer] on ``dsm``, the stream ``MIXER_DATA``
    that ``ds_dir`` holds. Returns (training launches, explainer launches,
    training numbers, explainer numbers)."""
    out = os.path.join(work, "mixer")
    say(f"[mixer-train] learn_base.main --base_type graphmixer at its "
        f"default flags (3 mixer blocks, batch {MIXER_BATCH}, dropout "
        f"{DROPOUT}, Adam lr {LR}), {N_DEGREE} neighbours = tokens, width "
        f"172 (token FFN 10, channel FFN 688), one epoch on ml_{MIXER_DATA} "
        f"(train {len(dsm.train)}, val {len(dsm.val)}, test "
        f"{len(dsm.test)} events)")
    launches, _, numbers, snap = base_train(
        dsm, ds_dir, out, torch, "graphmixer", mixer_argv, MIXER_PER_STEP,
        MIXER_BATCH, MIXER_CKPT_STEP, MIXER_DATA, layers=3)
    say(f"[mixer-resume] --resume from the state of a run stopped right "
        f"after its --ckpt_every_steps {MIXER_CKPT_STEP} checkpoint, to the "
        f"end of the epoch")
    t0 = time.perf_counter()
    base_resume(ds_dir, os.path.join(work, "mixer_resume"), snap,
                "graphmixer", mixer_argv, MIXER_DATA, MIXER_CKPT_STEP)
    say(f"  resumed and finished in {time.perf_counter() - t0:.2f} s")
    say("[eval-only] learn_base --eval_only on the GraphMixer of "
        "[mixer-train], the TGAT of [tgat-train] and the TGN of [train]")
    eval_only(mixer_argv(ds_dir, out), os.path.join(
        out, "results", f"base_graphmixer_{MIXER_DATA}.json"), "GraphMixer")
    tgat_out = os.path.join(work, "tgat")
    eval_only(tgat_argv(ds_dir, tgat_out), os.path.join(
        tgat_out, "results", f"base_tgat_{TGAT_DATA}.json"), "TGAT")
    tgn_eval_only(ds_dir, os.path.join(work, "train"), dev)
    say(f"[mixer-reference] one GraphMixer train step (batch "
        f"{MIXER_REF_BATCH}, width 172, dropout {DROPOUT}) on the card "
        f"against the CPU from the trained checkpoint at float32 (loss rtol "
        f"1e-4; gradients rtol 1e-3, atol 5e-4 of the tensor's largest; "
        f"params after Adam rtol 1e-5, atol 1e-6 where settled, within lr "
        f"elsewhere); the committed uslegis GraphMixer's contrast")
    check_mixer_train_against_cpu(dsm, out, dev)
    check_uslegis_mixer(dsm, dev)
    ckpt = os.path.join(out, "params")
    say(f"[mixer-explain] temp_exp_main.main --base_type graphmixer on the "
        f"frozen GraphMixer of [mixer-train] (hop-0 explanations): one "
        f"epoch, batch {EXPLAIN_BATCH}, {N_DEGREE} neighbours, 60 walks a "
        f"side, out_dim 40, hid_dim 64, dropout {DROPOUT}, Adam lr {LR}, "
        f"then val and test with fidelity and the 16-ratio sweep")
    x_launches, x_numbers, x_results, x_snap = explain(
        dsm, ds_dir, ckpt, os.path.join(work, "mixer_explain"), torch,
        base_type="graphmixer", data=MIXER_DATA,
        per_step=MIXER_EXPLAIN_PER_STEP,
        resume_step=MIXER_EXPLAIN_RESUME_STEP)
    say(f"  --resume from the state of a run stopped right after its "
        f"--ckpt_every_steps {MIXER_EXPLAIN_RESUME_STEP} checkpoint")
    t0 = time.perf_counter()
    explain_resume(ds_dir, ckpt, os.path.join(work, "mixer_explain_resume"),
                   x_snap, base_type="graphmixer", data=MIXER_DATA,
                   resume_step=MIXER_EXPLAIN_RESUME_STEP)
    say(f"  resumed and finished in {time.perf_counter() - t0:.2f} s")
    say("  --eval_only on the saved GraphMixer explainer")
    explain_eval_only(ds_dir, ckpt, os.path.join(work, "mixer_explain_eval"),
                      x_results, base_type="graphmixer", data=MIXER_DATA)
    say(f"  one explainer train step (batch {EXPLAIN_BATCH}, dropout "
        f"{DROPOUT}, injected draws) and one eval step's sweep on the card "
        f"against the CPU at float32, the tolerances of "
        f"[explain-reference] but the logits' atol 2e-4")
    # atol 2e-4 on the logits (the TGN's 1e-5): an anchor with a single
    # history event gets n identical tokens, whose token LayerNorm divides
    # the round-off of their mean by sqrt(1e-5), about 316 times; so the
    # card's and the CPU's orders of summation (and 1e-7 of difference in
    # the explain weights) move such a row's logit by up to 4.2e-5 (the
    # first card run), where other rows move by 1e-6
    check_explainer_against_cpu(dsm, ckpt, dev, base_type="graphmixer",
                                data=MIXER_DATA, logit_atol=2e-4)
    say(f"[trace-mixer] torch.profiler over 20 GraphMixer train steps at "
        f"batch {MIXER_BATCH}, then 20 explainer train steps on it at batch "
        f"{EXPLAIN_BATCH} (not counted above)")
    profile_mixer_training(dsm, out, dev)
    profile_explainer(dsm, ckpt, dev, base_type="graphmixer",
                      data=MIXER_DATA)
    return launches, x_launches, numbers, x_numbers


# ---------------------------------------------------------------------------
# Enhance, the pipeline's third stage, on the 15,000-event cut: a TGN
# base trained here first, the GraphMixer of [mixer-train], and (walks
# alone) the TGAT branch with the n_degree of [tgat-train]'s checkpoint
ENHANCE_DATA = CUT_DATA
# the same events for the TGN, its node table ending at the cut's largest
# node id (the cut never holds the last 5 item ids, whose rows a TGN's
# memory would lack)
ENHANCE_TGN_DATA = CUT_DATA + "tgn"
ENHANCE_BATCH = 100                  # enhance_main's default
ENHANCE_REF_BATCH = 32               # the card-vs-CPU step's batch
# launches per step: every base samples 3 sides x 2 hops and each side's
# walk events 2 and 3; a TGN embeds 3 sides x 2 layers (the training form
# and its backward in a train step, the eval form in an eval step); no
# step carries walks onto edges
_ENHANCE_WALKS = dict(sample_rows=6, sample_union=3, sample_masked=3,
                      walk_to_edge=0, walk_to_edge_bwd=0)
_NO_ATTENTION = dict(attend=0, attend_drop=0, attend_bwd=0)
ENHANCE_PER_STEP = {
    "tgn": {"train": dict(_ENHANCE_WALKS, attend=0, attend_drop=6,
                          attend_bwd=6),
            "eval": dict(_ENHANCE_WALKS, attend=6, attend_drop=0,
                         attend_bwd=0)},
    "graphmixer": {p: dict(_ENHANCE_WALKS, **_NO_ATTENTION)
                   for p in ("train", "eval")}}
ENHANCE_PER_STEP["tgat"] = ENHANCE_PER_STEP["graphmixer"]
USLEGIS_ENHANCE = "params/enhance/{}/uslegis_sampled.msgpack"


def enhance_argv(ds_dir, ckpt_dir, out, base_type, data, *extra):
    """``enhance_main`` at its defaults (batch 100, 60 walks a side,
    out_dim 40, hid_dim 64, dropout 0.1, Adam lr 1e-3), one epoch."""
    return ["--data", data, "--data_dir", ds_dir,
            "--base_type", base_type, "--ckpt_dir", ckpt_dir,
            "--n_epoch", "1", "--seed", str(SEED),
            "--log_dir", os.path.join(out, "tb"),
            "--results_dir", os.path.join(out, "results"), *extra]


def enhance_ckpt_dir(out, base_ckpt_dir, base_type, data, base_data=None):
    """A checkpoint directory under ``out`` that holds a copy of the base's
    checkpoint (``tgnn/``; trained on ``base_data``, by default ``data``)
    under ``data``'s name, beside which enhance writes its own."""
    import shutil
    mine = os.path.join(out, "params")
    os.makedirs(os.path.join(mine, "tgnn"))
    for suffix in ("", ".json"):
        shutil.copy(os.path.join(base_ckpt_dir, "tgnn",
                                 f"{base_type}_{base_data or data}.pt"
                                 f"{suffix}"),
                    os.path.join(mine, "tgnn",
                                 f"{base_type}_{data}.pt{suffix}"))
    return mine


def enhance(ds, ds_dir, base_ckpt_dir, out, torch, base_type,
            data=ENHANCE_DATA, epochs=1, per_step=None, base_data=None):
    """``enhance_main.main`` for ``epochs`` epochs at full width on the
    card on the base of ``base_ckpt_dir``, with ``per_step`` launches of
    each kernel per train and eval step (``ENHANCE_PER_STEP`` of the base
    type by default): finite losses, APs in
    [0, 1], the files written, the saved base moved off the loaded one. A
    run of 2 epochs also keeps a copy of its enhance directory as it stood
    after epoch 0. ``base_data``: the stream the base was trained on, when
    not ``data``. Returns (launches, numbers, checkpoint dir, that
    copy)."""
    import math
    import shutil
    from tempme_tpu_torch.train import enhance_main
    from tempme_tpu_torch.utils.checkpoint import load_checkpoint
    kernels = explain_kernels()
    is_tgat = base_type == "tgat"
    steps = {"train": len(ds.train) // ENHANCE_BATCH,
             "eval": math.ceil(len(ds.test) / ENHANCE_BATCH)
             + (0 if is_tgat else math.ceil(len(ds.val) / ENHANCE_BATCH))}
    per_step = per_step or ENHANCE_PER_STEP[base_type]
    want = {k: epochs * sum(per_step[p][k] * n for p, n in steps.items())
            for k in kernels}
    ckpt_dir = enhance_ckpt_dir(out, base_ckpt_dir, base_type, data,
                                base_data)
    snapshot = os.path.join(out, "after_epoch0")
    save = enhance_main.save_checkpoint

    def snapshotting_save(path, blob, meta=None):
        save(path, blob, meta=meta)
        if epochs > 1 and path.endswith(".train_state") and \
                meta["epoch"] == 0:
            shutil.copytree(os.path.dirname(path), snapshot)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in kernels.values():
        f.launches = 0
    enhance_main.save_checkpoint = snapshotting_save
    printed = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            ap = enhance_main.main(enhance_argv(
                ds_dir, ckpt_dir, out, base_type, data, "--n_epoch",
                str(epochs)))
    finally:
        enhance_main.save_checkpoint = save
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: f.launches for name, f in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    for line in printed.getvalue().splitlines():
        say(f"    | {line}")
    say(f"  launches on the {base_type} enhance path: {launches} for "
        f"{epochs} x ({steps['train']} train and {steps['eval']} eval "
        f"steps); per step {per_step}")
    check_launches(launches, want)
    tags = read_metrics(out)
    losses = tags["Train/step_loss"]
    if len(losses) != epochs * steps["train"] or \
            not all(map(math.isfinite, losses)):
        raise AssertionError(f"an enhance {base_type} loss is missing or "
                             "not finite")
    tenth = max(1, steps["train"] // 10)
    first, last = (sum(x) / len(x) for x in (losses[:tenth],
                                              losses[-tenth:]))
    eps = tags["Train/events_per_s"][0]
    numbers = dict(train_ms_per_step=ENHANCE_BATCH / eps * 1e3,
                   events_per_s=eps, loss_first_tenth=first,
                   loss_last_tenth=last, train_ap=tags["Train/ap"][0],
                   test_ap=tags["Test/ap"][0], test_auc=tags["Test/auc"][0],
                   best_test_ap=ap, peak_gib=peak / 2 ** 30, wall_s=wall,
                   train_steps=steps["train"], eval_steps=steps["eval"])
    if not is_tgat:
        numbers["val_ap"] = tags["Val/ap"][0]
    for key in ("train_ap", "test_ap", "test_auc", "best_test_ap",
                "val_ap"):
        if key in numbers and not 0.0 <= numbers[key] <= 1.0:
            raise AssertionError(f"enhance {base_type} {key} "
                                 f"{numbers[key]} outside [0, 1]")
    best = os.path.join(ckpt_dir, "enhance", base_type, f"{data}.pt")
    paths = [best, best + ".json", os.path.join(
        out, "results", f"enhance_{base_type}_{data}.json")]
    if not is_tgat:
        paths.append(best + ".train_state")
    if epochs > 1:
        paths.append(snapshot)
    for path in paths:
        if not os.path.exists(path):
            raise AssertionError(f"missing {path}")
    if not is_tgat:
        saved, _ = load_checkpoint(best + ".train_state", map_location="cpu")
        loaded, _ = load_checkpoint(os.path.join(
            ckpt_dir, "tgnn", f"{base_type}_{data}.pt"), map_location="cpu")
        moved = sum(not torch.equal(saved["base"][k], x)
                    for k, x in loaded["params"].items())
        if not moved:
            raise AssertionError(f"enhance left the {base_type} base as it "
                                 f"was loaded")
        numbers["base_tensors_moved"] = moved
    say(f"  {epochs} x {steps['train']} steps: "
        f"{numbers['train_ms_per_step']:.3f} ms/step, {eps:.1f} events/s "
        f"(the driver's epoch clock, epoch 0); mean loss first tenth "
        f"{first:.6f}, last tenth {last:.6f}; train AP "
        f"{numbers['train_ap']:.6f}, "
        + (f"val AP {numbers['val_ap']:.6f}, " if not is_tgat else "")
        + f"test AP {numbers['test_ap']:.6f}, AUC {numbers['test_auc']:.6f}"
        f" (epoch 0), best checkpoint's test AP {ap:.6f}; peak device "
        f"memory {peak / 2 ** 30:.3f} GiB; main() {wall:.2f} s with loading "
        f"and eval"
        + (f"; {numbers['base_tensors_moved']} of the base's tensors moved"
           if not is_tgat else ""))
    return launches, numbers, ckpt_dir, snapshot


def enhance_resume(ds_dir, whole_dir, snapshot, out, base_type):
    """``--n_epoch 2 --resume`` from ``snapshot`` (the enhance directory of
    a 2-epoch run as it stood after epoch 0: its train state and best
    checkpoint) in a fresh directory: the train state (both models, Adam,
    the generator), the best checkpoint and the results equal, tensor by
    tensor, those the uninterrupted run (``whole_dir``) wrote."""
    import shutil
    import torch
    from tempme_tpu_torch.train import enhance_main
    from tempme_tpu_torch.utils.checkpoint import load_checkpoint
    mine = enhance_ckpt_dir(out, whole_dir, base_type, ENHANCE_DATA)
    shutil.copytree(snapshot, os.path.join(mine, "enhance", base_type))
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        enhance_main.main(enhance_argv(ds_dir, mine, out, base_type,
                                       ENHANCE_DATA, "--n_epoch", "2",
                                       "--resume"))
    if "at epoch 1" not in printed.getvalue():
        raise AssertionError("the enhance run did not resume at epoch 1")
    for line in printed.getvalue().splitlines()[-4:]:
        say(f"    | {line}")

    def same(a, b, where):
        if isinstance(a, torch.Tensor):
            if not torch.equal(a, b):
                raise AssertionError(f"{where} differs from the "
                                     f"uninterrupted run")
        elif isinstance(a, dict):
            if a.keys() != b.keys():
                raise AssertionError(f"{where}: keys differ")
            for k in a:
                same(a[k], b[k], f"{where}.{k}")
        elif isinstance(a, (list, tuple)):
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{where}[{i}]")
        elif a != b:
            raise AssertionError(f"{where}: {a} != {b}")

    best = os.path.join("enhance", base_type, f"{ENHANCE_DATA}.pt")
    for name in (best, best + ".train_state"):
        same(load_checkpoint(os.path.join(mine, name), "cpu")[0],
             load_checkpoint(os.path.join(whole_dir, name), "cpu")[0], name)
    for a, b in ((os.path.join(mine, best + ".json"),
                  os.path.join(whole_dir, best + ".json")),
                 (os.path.join(mine, best + ".train_state.json"),
                  os.path.join(whole_dir, best + ".train_state.json")),
                 (os.path.join(out, "results",
                               f"enhance_{base_type}_{ENHANCE_DATA}.json"),
                  os.path.join(os.path.dirname(whole_dir), "results",
                               f"enhance_{base_type}_{ENHANCE_DATA}.json"))):
        with open(a) as fa, open(b) as fb:
            if json.load(fa) != json.load(fb):
                raise AssertionError(f"{a} differs from {b}")
    say("  the resumed run's train state (both models, Adam, the "
        "generator), best checkpoint and results equal the uninterrupted "
        "2-epoch run's, tensor by tensor")


def enhance_steps_on(dev, ds, ckpt_dir, base_type, compute_dtype, data):
    """The enhance train step on ``dev`` from what [enhance-*] wrote in
    ``ckpt_dir``: for a TGN or a GraphMixer its train state (predictor,
    base with a TGN's projections at ``compute_dtype``, Adam, memory), for
    a TGAT its best predictor and a fresh Adam. Returns (step, memory)."""
    import torch
    from tempme_tpu_torch.data.events import RandEdgeSampler
    from tempme_tpu_torch.data.graph import build_temporal_graph
    from tempme_tpu_torch.explain.tempme import TempME
    from tempme_tpu_torch.explain.tempme_tgat import TempMETGAT
    from tempme_tpu_torch.models.common import Features
    from tempme_tpu_torch.models.tgn import TGNMemoryState
    from tempme_tpu_torch.tools.node_degrees import compute_node_degrees
    from tempme_tpu_torch.train.base_loader import load_base
    from tempme_tpu_torch.train.enhance_main import EnhanceTrainStep
    from tempme_tpu_torch.utils.checkpoint import load_checkpoint
    g = build_temporal_graph(ds.train, ds.full.num_nodes, ds.full.num_edges,
                             device=dev)
    feats = Features(torch.from_numpy(ds.node_feat).to(dev),
                     torch.from_numpy(ds.edge_feat).to(dev))
    dst = RandEdgeSampler([ds.train.src], [ds.train.dst]).dst_list
    deg = torch.from_numpy(compute_node_degrees(ds.full)).to(dev)
    best = os.path.join(ckpt_dir, "enhance", base_type, f"{data}.pt")
    dims = (ds.node_feat.shape[1], ds.edge_feat.shape[1])
    mem = base = None
    if base_type == "tgat":
        blob, _ = load_checkpoint(best, map_location="cpu")
        predictor = TempMETGAT(*dims, device=dev, seed=SEED)
        predictor.load_state_dict(blob["predictor"])
        opt = torch.optim.Adam(predictor.parameters(), lr=LR)
    else:
        blob, _ = load_checkpoint(best + ".train_state", map_location="cpu")
        base = load_base(os.path.join(ckpt_dir, "tgnn",
                                      f"{base_type}_{data}.pt"),
                         device=dev, compute_dtype=compute_dtype,
                         trainable=True)
        base.model.load_state_dict(blob["base"])
        predictor = TempME(*dims, base_type=base_type, device=dev, seed=SEED)
        predictor.load_state_dict(blob["predictor"])
        opt = torch.optim.Adam(
            [{"params": list(predictor.parameters())},
             {"params": list(base.model.parameters()), "weight_decay": 0.0}],
            lr=LR)
        opt.load_state_dict(copy.deepcopy(blob["opt_state"]))
        if base_type == "tgn":
            mem = TGNMemoryState(**{k: v.to(dev)
                                    for k, v in blob["memory"].items()})
    step = EnhanceTrainStep(predictor, base, g, feats,
                            torch.from_numpy(dst).to(dev), N_DEGREE, deg,
                            opt)
    return step, mem


class _Joint:
    """The predictor and the base as one ``model`` (``compare_train_steps``
    reads ``model.named_parameters()``)."""

    def __init__(self, step):
        import torch
        parts = {"predictor": step.predictor}
        if step.base is not None:
            parts["base"] = step.base.model
        self.model = torch.nn.ModuleDict(parts)


# the layers whose output enters a ReLU (the TGN's message MLP and
# merges, TempME's event conv, motif attention and affinity, the TGAT
# predictor's feed-forwards and walk MLP): a pre-activation within
# round-off of zero lands on the ReLU's other side on one device, and that
# sample's whole outer product then enters one side's gradient only, in one
# hidden unit's row and bias. On an H100 the TGN's first message-MLP layer
# differed so by 4.8e-4 of its largest (unit 95) and the TGAT predictor's
# walk_enc_cat.fc1 by 3.6e-4 (unit 242); every other tensor of the three
# enhance steps stayed within 1.5e-4
RELU_FED = ("message_mlp.0.", "merger.fc1.", "event_conv.fc1.",
            "event_conv.lin_event.", "attention.fc1.", "aff_fc1.",
            "event_enc.fc1.", "walk_enc_cat.fc1.", "mlp_attn_d1.")


def check_enhance_against_cpu(ds, ckpt_dir, dev, base_type, grad_atol,
                              data=ENHANCE_DATA):
    """One enhance train step (batch ``ENHANCE_REF_BATCH``, dropout 0.1,
    the same draws) on the card and on the CPU from the same state at
    float32: ``compare_train_steps`` over predictor and base at
    ``grad_atol`` (the base's own train step's: a TGN's and a TGAT's 1e-4,
    a GraphMixer's 5e-4), 1e-3 for the layers that feed a ReLU
    (``RELU_FED``), the attention key biases of a TGAT's predictor as exact
    zeros, and its step as Adam's first (no train state); a TGN's new
    memory rtol 2e-4, atol 1e-5 (its flags exactly). A TGAT's step also
    runs on the CPU in float64 (predictor, features, degrees and draws
    cast, as ``chip_probes/probe_enh_tgat.py``), and a gradient outside
    its tolerance passes if the card is at most ``CONDITIONED_CAP`` times
    as far from that as the CPU's float32 (C11: a quarter of the 15,000-
    event cut's walks are all padding), its parameter after Adam then held
    to Adam replayed in float64 with the card's gradient. Returns the
    tensors that passed so, with their ratios."""
    import torch
    from tempme_tpu_torch.models.common import Features
    from tempme_tpu_torch.train import loops
    cpu = torch.device("cpu")
    step_c, mem_c = enhance_steps_on(cpu, ds, ckpt_dir, base_type,
                                     torch.float32, data)
    step_g, mem_g = enhance_steps_on(dev, ds, ckpt_dir, base_type,
                                     torch.float32, data)
    batch = loops.Batch(*(x[0] for x in loops.stack_batches(
        ds.train, ENHANCE_REF_BATCH, True, SEED + 1, cpu)))
    gen = torch.Generator(device=cpu)
    gen.manual_seed(SEED + 31)
    draws = step_c.draw(gen, ENHANCE_REF_BATCH)
    start = {name: (p.detach().cpu().clone(), copy.deepcopy(
        {k: v.cpu() if torch.is_tensor(v) else v
         for k, v in step_g.optimizer.state.get(p, {}).items()}))
        for name, p in _Joint(step_g).model.named_parameters()}
    new_c, aux_c = step_c(mem_c, batch, draws)
    new_g, aux_g = step_g(mem_g, to_device(batch, dev),
                          to_device(draws, dev))
    torch.cuda.synchronize()
    reference = None
    if base_type == "tgat":
        step64, _ = enhance_steps_on(cpu, ds, ckpt_dir, base_type,
                                     torch.float32, data)
        step64.predictor.double()
        step64.feats = Features(step64.feats.node.double(),
                                step64.feats.edge.double())
        step64.node_degree = step64.node_degree.double()
        step64(None, batch, draws._replace(pred=tuple(
            type(p)(*(x.double() for x in p)) for p in draws.pred)))
        reference = {k: (p.grad,) + start[k] for k, p in
                     _Joint(step64).model.named_parameters()}
    by_f64 = compare_train_steps(
        _Joint(step_c), aux_c, _Joint(step_g), aux_g,
        f"{base_type} enhance step", grad_atol=grad_atol,
        exact_zero=("self_attn.key.bias",),
        looser=tuple((part, 1e-3) for part in RELU_FED),
        fresh_adam=base_type == "tgat", reference=reference)
    if new_c is not None:
        for name, a, b in zip(new_c._fields, new_g, new_c):
            if a.dtype == torch.bool:
                if not torch.equal(a.cpu(), b):
                    raise AssertionError(f"memory {name} differs from the "
                                         f"CPU")
            else:
                torch.testing.assert_close(a.cpu(), b, rtol=2e-4, atol=1e-5)
        say("  the TGN's new memory agrees")
    return by_f64


def check_uslegis_enhance(ds, dev):
    """The committed uslegis enhance checkpoints (read by the port's own
    reader; the TGN's predictor at hid_dim 32, the GraphMixer's base with
    the 2 blocks JAX's loader trained, C7; the TGAT's predictor alone)
    score 8 events of the stream (edge features cut to width 1) through
    the base's embeddings and ``enhance_predict_agg`` over supports and
    walks of n 30, on the card and on the CPU with the same inputs, at
    float32: rtol 2e-4, atol 1e-5."""
    import torch
    from tempme_tpu_torch.data.events import RandEdgeSampler
    from tempme_tpu_torch.data.graph import build_temporal_graph
    from tempme_tpu_torch.explain.tempme import TempME
    from tempme_tpu_torch.explain.tempme_tgat import TempMETGAT
    from tempme_tpu_torch.models.common import Features
    from tempme_tpu_torch.models.graphmixer import GraphMixer
    from tempme_tpu_torch.models.tgn import TGN, init_memory_state
    from tempme_tpu_torch.tools.node_degrees import compute_node_degrees
    from tempme_tpu_torch.train import loops
    from tempme_tpu_torch.train.enhance_main import N_WALK_CONT
    from tempme_tpu_torch.train.temp_exp_main import sample_explainer_inputs
    from tempme_tpu_torch.utils.checkpoint import load_meta
    from tempme_tpu_torch.utils.convert import (enhance_state_dicts,
                                                mixer_blocks,
                                                read_flax_msgpack)
    cpu = torch.device("cpu")
    n, b = 30, 8
    g = build_temporal_graph(ds.full, ds.full.num_nodes, ds.full.num_edges,
                             device=cpu)
    feats = Features(torch.from_numpy(ds.node_feat),
                     torch.from_numpy(ds.edge_feat[:, :1].copy()))
    dst = torch.from_numpy(RandEdgeSampler([ds.test.src],
                                           [ds.test.dst]).dst_list)
    deg = torch.from_numpy(compute_node_degrees(ds.full))
    batch = next(loops.iter_batches(ds.test, b, False, cpu))
    gen = torch.Generator(device=cpu)
    gen.manual_seed(SEED + 37)
    draws = loops.draw_enhance(gen, b, n, N_WALK_CONT, dst.shape[0], cpu)
    bgd, subs, walks = sample_explainer_inputs(g, batch, dst, n, draws)
    for base_type in ("tgn", "graphmixer", "tgat"):
        path = os.path.join(ROOT, USLEGIS_ENHANCE.format(base_type))
        meta = load_meta(path)
        sd = enhance_state_dicts(read_flax_msgpack(path))
        out = []
        for d in (cpu, dev):
            if base_type == "tgat":
                pred = TempMETGAT(172, 1, out_dim=meta["out_dim"],
                                  hid_dim=meta["hid_dim"], device=d)
            else:
                pred = TempME(172, 1, out_dim=meta["out_dim"],
                              hid_dim=meta["hid_dim"], base_type=base_type,
                              device=d)
            pred.load_state_dict(sd["predictor"])
            args = [to_device(feats, d), batch.ts.to(d),
                    *(to_device(w, d) for w in walks)]
            ids = [x.to(d) for x in (batch.src, batch.dst, bgd, batch.ts)]
            dsubs = [to_device(s, d) for s in subs]
            with torch.no_grad():
                if base_type == "tgn":           # zero memory, a row a node
                    nodes = ds.node_feat.shape[0]
                    model = TGN(172, 1, nodes, device=d,
                                compute_dtype=torch.float32)
                    model.load_state_dict(sd["base"])
                    mem = init_memory_state(nodes, model.memory_dim,
                                            model.raw_message_dim, device=d)
                    embs, _ = model.get_node_emb(
                        args[0], mem, *ids, batch.eidx.to(d), *dsubs,
                        update_memory=False)
                    args += list(embs)
                elif base_type == "graphmixer":
                    model = GraphMixer(172, 1, n,
                                       num_layers=mixer_blocks(sd["base"]),
                                       device=d)
                    model.load_state_dict(sd["base"])
                    args += list(model.get_node_emb(args[0], *ids, *dsubs))
                out.append(pred.enhance_predict_agg(*args, deg.to(d)))
        torch.cuda.synchronize()
        for a, c in zip(out[1], out[0]):
            torch.testing.assert_close(a.cpu(), c, rtol=2e-4, atol=1e-5)
        err = max((a.cpu() - c).abs().max().item()
                  for a, c in zip(out[1], out[0]))
        blocks = f", {mixer_blocks(sd['base'])} blocks (C7)" \
            if base_type == "graphmixer" else ""
        say(f"  uslegis {base_type} enhance (out_dim {meta['out_dim']}, "
            f"hid_dim {meta['hid_dim']}{blocks}): logits card against CPU "
            f"max abs err {err:.3e} at float32 (rtol 2e-4, atol 1e-5)")


def profile_enhance(ds, ckpt_dir, dev, n_steps=20):
    """20 TGN enhance train steps at batch 100 as the driver runs them
    (bf16 projections, draws from a generator), from [enhance-tgn]'s train
    state."""
    import torch
    from tempme_tpu_torch.train import loops
    step, mem = enhance_steps_on(dev, ds, ckpt_dir, "tgn", torch.bfloat16,
                                 ENHANCE_TGN_DATA)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 41)
    batches = loops.stack_batches(ds.train, ENHANCE_BATCH, True, SEED + 7,
                                  dev)
    work = [loops.Batch(*(x[i] for x in batches)) for i in range(n_steps)]
    state = [mem]

    def run(i):
        state[0], _ = step(state[0], work[i],
                           step.draw(gen, ENHANCE_BATCH))
    run(0)                                   # warm up off the window
    profile_steps(run, n_steps)


def enhance_tgn_base_argv(ds_dir, out, *extra):
    """``learn_base --base_type tgn`` on the 15,000-event cut, at the TGN
    cells' flags (batch 256, 20 neighbours, dropout 0.1, Adam lr 1e-3),
    one epoch."""
    return ["--data", ENHANCE_TGN_DATA, "--data_dir", ds_dir,
            "--base_type", "tgn", "--bs", str(BATCH),
            "--n_degree", str(N_DEGREE), "--n_epoch", "1",
            "--drop_out", str(DROPOUT), "--lr", str(LR), "--seed", str(SEED),
            "--out_dir", os.path.join(out, "params", "tgnn"),
            "--log_dir", os.path.join(out, "tb"),
            "--results_dir", os.path.join(out, "results"), *extra]


def enhance_phases(work, ds_dir, ds30, dev, torch):
    """[enhance-tgn], [enhance-mixer], [enhance-resume], [enhance-tgat],
    [enhance-reference] and [trace-enhance] on ``ds30``, the stream
    ``ENHANCE_DATA`` that ``ds_dir`` holds. Returns (launches per path,
    numbers per path)."""
    from tempme_tpu_torch.data.events import load_dataset
    from tempme_tpu_torch.train import learn_base
    base_out = os.path.join(work, "enhance_tgn_base")
    write_stream(ds_dir, ENHANCE_TGN_DATA, CUT_EVENTS, trim_nodes=True)
    ds_tgn = load_dataset(ENHANCE_TGN_DATA, ds_dir)
    say(f"[enhance-tgn] learn_base --base_type tgn on ml_{ENHANCE_TGN_DATA} "
        f"(the events of ml_{ENHANCE_DATA}, the node table cut to its "
        f"{ds_tgn.node_feat.shape[0]} ids; batch {BATCH}, {N_DEGREE} "
        f"neighbours, dropout {DROPOUT}, one "
        f"epoch), then enhance_main --base_type tgn on it: one epoch at its "
        f"defaults (batch {ENHANCE_BATCH}, 60 walks a side, out_dim 40, "
        f"hid_dim 64, dropout {DROPOUT}, Adam lr {LR}), the base trained "
        f"jointly (bf16 projections), then val and test")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        base_ap = learn_base.main(enhance_tgn_base_argv(ds_dir, base_out))
    if not 0.0 <= base_ap <= 1.0:
        raise AssertionError(f"the enhance TGN base's test AP {base_ap}")
    say(f"  the TGN base: test AP {base_ap:.6f}, trained in "
        f"{time.perf_counter() - t0:.2f} s")
    launches, numbers = {}, {}
    launches["enhance-tgn"], numbers["enhance-tgn"], tgn_ckpt, _ = enhance(
        ds_tgn, ds_dir, os.path.join(base_out, "params"),
        os.path.join(work, "enhance_tgn"), torch, "tgn", ENHANCE_TGN_DATA)
    say("[enhance-mixer] enhance_main --base_type graphmixer on the "
        "GraphMixer of [mixer-train] (3 blocks, all trained jointly): 2 "
        "epochs uninterrupted, the second for [enhance-resume]")
    mixer_out = os.path.join(work, "enhance_mixer")
    launches["enhance-mixer"], numbers["enhance-mixer"], mixer_ckpt, snap = \
        enhance(ds30, ds_dir, os.path.join(work, "mixer", "params"),
                mixer_out, torch, "graphmixer", epochs=2)
    say("[enhance-resume] --n_epoch 2 --resume from the enhance GraphMixer's "
        "state after epoch 0, against the uninterrupted 2-epoch run")
    t0 = time.perf_counter()
    enhance_resume(ds_dir, mixer_ckpt, snap,
                   os.path.join(work, "enhance_mixer_resume"), "graphmixer")
    say(f"  resumed and finished in {time.perf_counter() - t0:.2f} s")
    say(f"[enhance-tgat] enhance_main --base_type tgat (TempMETGAT on the "
        f"walks alone, 8 heads, walk_enc_cat at width 52; n_degree from "
        f"[tgat-train]'s checkpoint meta) on ml_{ENHANCE_DATA}: one epoch, "
        f"then test")
    launches["enhance-tgat"], numbers["enhance-tgat"], tgat_ckpt, _ = \
        enhance(ds30, ds_dir, os.path.join(work, "tgat", "params"),
                os.path.join(work, "enhance_tgat"), torch, "tgat",
                base_data=TGAT_DATA)
    say(f"[enhance-reference] one enhance train step (batch "
        f"{ENHANCE_REF_BATCH}, dropout {DROPOUT}, the same draws) of each "
        f"base on the card against the CPU from the state its run wrote, at "
        f"float32 (loss rtol 1e-4; gradients of predictor and base rtol "
        f"1e-3, atol 1e-4 of the tensor's largest, 5e-4 for a GraphMixer, "
        f"1e-3 for a layer that feeds a ReLU; a TGAT's gradient outside "
        f"these also passes if the card is at most {CONDITIONED_CAP} times "
        f"as far from a CPU float64 step as the CPU float32, its params "
        f"then held to Adam replayed in float64 with the card's gradient; "
        f"params after Adam rtol 1e-5, atol 1e-6 where settled, within lr "
        f"elsewhere, 2 lr after the TGAT's fresh Adam; a TGN's memory rtol "
        f"2e-4, atol 1e-5); the committed "
        f"uslegis enhance checkpoints")
    check_enhance_against_cpu(ds_tgn, tgn_ckpt, dev, "tgn", 1e-4,
                              ENHANCE_TGN_DATA)
    check_enhance_against_cpu(ds30, mixer_ckpt, dev, "graphmixer", 5e-4)
    numbers["enhance-tgat"]["by_float64"] = check_enhance_against_cpu(
        ds30, tgat_ckpt, dev, "tgat", 1e-4)
    check_uslegis_enhance(ds30, dev)
    say(f"[trace-enhance] torch.profiler over 20 TGN enhance train steps at "
        f"batch {ENHANCE_BATCH} (not counted above)")
    profile_enhance(ds_tgn, tgn_ckpt, dev)
    return launches, numbers


# ---------------------------------------------------------------------------
# The pipeline as users start it (``python -m tempme_tpu_torch.cli``): the
# offline walk cache of the TGN's cut ([cache]), the explainer trained from
# it ([cache-explain]) on the TGN of [enhance-tgn], and ``pipeline``
# (learn-base -> explain -> enhance) with ``validate`` ([pipeline])
CACHE_BATCH = 128                    # preprocess's default --bs
CACHE_PER_BATCH = dict(sample_rows=6, sample_union=3, sample_masked=3)
_NO_SAMPLING = dict(sample_rows=0, sample_union=0, sample_masked=0)
# the cached explainer: train steps and test's eval steps read the cache,
# val's eval steps and the null model's batches sample online
CACHE_EXPLAIN_PER_STEP = {
    "train": dict(EXPLAIN_PER_STEP["train"], **_NO_SAMPLING),
    "eval": EXPLAIN_PER_STEP["eval"],
    "cached_eval": dict(EXPLAIN_PER_STEP["eval"], **_NO_SAMPLING),
    "null": EXPLAIN_PER_STEP["null"]}
CACHE_SHAPES = ("cache hop0 Q=128", "cache hop1 Q=2560",
                "cache sample_union Q=2560", "cache sample_masked Q=7680")


def check_cache_kernels(ds, g, torch, dev):
    """The three sampling kernels against their plain versions, bitwise, at
    the shapes ``build_walk_cache`` gives them (batch 128, 20 neighbours,
    3 continuations) on its inputs for the batch in the middle of the train
    split (side src: hop 0 cut at the batch's edges, hop 1, the walks'
    second and third events), with their times and bounds. Returns the
    rows."""
    import numpy as np
    from tempme_tpu_torch.data import cache as C
    from tempme_tpu_torch.data.events import RandEdgeSampler
    from tempme_tpu_torch.ops import sampler as S
    from tempme_tpu_torch.ops.kernels.sample_masked import (
        sample_masked, sample_masked_plain)
    from tempme_tpu_torch.ops.kernels.sample_rows import (sample_rows,
                                                          sample_rows_plain)
    from tempme_tpu_torch.ops.kernels.sample_union import (
        sample_union, sample_union_plain)
    from tempme_tpu_torch.tools.walk_ab import recording
    b, n = CACHE_BATCH, N_DEGREE
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 31)
    mid = len(ds.train) // 2
    sl = slice(mid, mid + b)
    fake = RandEdgeSampler([ds.train.src], [ds.train.dst], seed=SEED).sample(
        b)[1]
    cols = [torch.from_numpy(np.ascontiguousarray(x[sl])).to(dev)
            for x in (ds.train.src, ds.train.dst)]
    with recording(S, ("sample_rows", "sample_union", "sample_masked")) \
            as rec:
        C.sample_cache_batch(
            g, *cols, torch.from_numpy(fake.astype(np.int32)).to(dev),
            torch.from_numpy(ds.train.ts[sl]).to(dev),
            torch.from_numpy(ds.train.e_idx[sl]).to(dev), n, 3,
            C.draw_cache_batch(gen, b, n, 3, dev))
    hop0, hop1 = rec["sample_rows"][:2]
    union, masked = rec["sample_union"][0], rec["sample_masked"][0]
    rows = {}
    for name, kernel, plain, args in (
            (CACHE_SHAPES[0], sample_rows, sample_rows_plain, hop0),
            (CACHE_SHAPES[1], sample_rows, sample_rows_plain, hop1),
            (CACHE_SHAPES[2], sample_union, sample_union_plain, union),
            (CACHE_SHAPES[3], sample_masked, sample_masked_plain, masked)):
        got, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise AssertionError(f"{name} differs from its plain version")
        if not (got[-1] if kernel is sample_masked else got[1] > 0).any():
            raise AssertionError(f"{name} sampled nothing")
        gg, a = args[0], args[1:]
        if kernel is sample_rows:
            nbytes = sample_rows_bytes(gg, a[0], a[1], a[2], a[3])
            ops, rate = a[2].shape[0] * n * (2 * n + 4), H100_INT32_OPS_PER_S
        elif kernel is sample_union:
            nbytes, ops, rate = union_bytes(gg, *a[:3], a[3].shape[1]), 0, \
                H100_F32_OPS_PER_S
        else:
            nbytes, ops, rate = masked_bytes(gg, a[0], a[1], a[2], a[6],
                                             got[4]), 0, H100_F32_OPS_PER_S
        ms, host = time_ms(lambda: kernel(*args))
        plain_ms, plain_host = time_ms(lambda: plain(*args))
        least, by = bound(nbytes, ops, rate)
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=least,
                          bound_by=by, library_ms=None)
        say(f"  {kernel.__name__} {name.split()[-1]}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {least:.5f} ms ({by}), bitwise "
            f"equal; eager calls from the host {host:.4f} / "
            f"{plain_host:.4f} ms")
    return rows


def check_cache_files(report, ds, n_batches):
    """Both splits' files: the keys, shapes and dtypes of the JAX
    package's format, ids in range, classes in [0, 12), the class
    distribution summing to 1, and ``dst_fake`` equal to the host
    sampler's draws (seeded from --seed, ``CACHE_BATCH`` a batch)."""
    import numpy as np
    from tempme_tpu_torch.data.cache import SIDES, load_cache
    from tempme_tpu_torch.data.events import RandEdgeSampler
    n, w = N_DEGREE, N_DEGREE * 3
    nn_, ne = ds.full.num_nodes, ds.full.num_edges
    caches = {}
    for mode, events, lists in (
            ("train", ds.train, ([ds.train.src], [ds.train.dst])),
            ("test", ds.test, ([ds.train.src, ds.val.src, ds.test.src],
                               [ds.train.dst, ds.val.dst, ds.test.dst]))):
        cache = load_cache(report[mode]["path"])
        k = len(events)
        want = {"dst_fake": ((k,), np.int32),
                "class_distribution": ((12,), np.float32)}
        for s in SIDES:
            want.update({
                f"subgraph_{s}_0": ((k, 3 * n), np.float32),
                f"subgraph_{s}_1": ((k, 3 * n * n), np.float32),
                f"walks_{s}_nodes": ((k, w, 6), np.int32),
                f"walks_{s}_eids": ((k, w, 3), np.int32),
                f"walks_{s}_ts": ((k, w, 3), np.float32),
                f"walks_{s}_cat": ((k, w), np.int32),
                f"walks_{s}_marginal": ((k, w), np.float32),
                f"edge_{s}": ((k, w, 3, 3), np.float32)})
        got = {key: (v.shape, v.dtype) for key, v in cache.items()}
        if got != {key: (sh, np.dtype(dt)) for key, (sh, dt) in
                   want.items()}:
            raise AssertionError(f"{mode} cache: {got}")
        for s in SIDES:
            for h, width in ((0, n), (1, n * n)):
                sub = cache[f"subgraph_{s}_{h}"]
                ids = sub[:, :2 * width]
                if not ((ids == np.round(ids)).all() and ids.min() >= 0
                        and sub[:, :width].max() < nn_
                        and sub[:, width:2 * width].max() < ne):
                    raise AssertionError(f"{mode} subgraph_{s}_{h}: ids")
            if not (0 <= cache[f"walks_{s}_nodes"].min()
                    and cache[f"walks_{s}_nodes"].max() < nn_
                    and 0 <= cache[f"walks_{s}_eids"].min()
                    and cache[f"walks_{s}_eids"].max() < ne):
                raise AssertionError(f"{mode} walks_{s}: ids out of range")
            cat = cache[f"walks_{s}_cat"]
            if not (cat.min() >= 0 and cat.max() < 12):
                raise AssertionError(f"{mode} walks_{s}_cat outside [0, 12)")
        dist = cache["class_distribution"]
        if abs(float(dist.sum()) - 1.0) > 1e-5:
            raise AssertionError(f"{mode} class distribution {dist}")
        sampler = RandEdgeSampler(*lists, seed=SEED)
        fake = np.concatenate([sampler.sample(CACHE_BATCH)[1]
                               for _ in range(n_batches[mode])])[:k]
        if not np.array_equal(cache["dst_fake"], fake):
            raise AssertionError(f"{mode} dst_fake is not the sampler's")
        caches[mode] = cache
    return caches


def check_cache_batch_against_cpu(ds, dev, torch):
    """The first train batch's cache arrays built on the card and on the
    CPU from the same draws and negatives: equal array by array."""
    import numpy as np
    from tempme_tpu_torch.data import cache as C
    from tempme_tpu_torch.data.events import RandEdgeSampler
    from tempme_tpu_torch.data.graph import build_temporal_graph
    gen = torch.Generator()
    gen.manual_seed(SEED + 33)
    draws = (C.draw_cache_batch(gen, CACHE_BATCH, N_DEGREE, 3, "cpu"),)
    events = ds.train.select(np.arange(len(ds.train)) < CACHE_BATCH)
    cpu, card = (C.build_walk_cache(
        build_temporal_graph(ds.train, ds.full.num_nodes, ds.full.num_edges,
                             device=d), events,
        RandEdgeSampler([ds.train.src], [ds.train.dst], seed=SEED),
        N_DEGREE, batch_size=CACHE_BATCH, draws=to_device(draws, d))
        for d in (torch.device("cpu"), dev))
    for key, v in cpu.items():
        if not np.array_equal(card[key], v):
            raise AssertionError(f"cache batch: {key} differs card/CPU")
    say(f"  one batch of {CACHE_BATCH} built on the card and on the CPU "
        f"from the same draws: {len(cpu)} arrays equal")


def cache_explain_argv(ds_dir, ckpt_dir, cache_dir, out, *extra):
    return ["explain", "--use_cache", "--cache_dir", cache_dir,
            *explain_argv(ds_dir, ckpt_dir, out, data=ENHANCE_TGN_DATA),
            *extra]


def cache_phases(work, ds_dir, dev, torch, online_ms):
    """[cache] and [cache-explain] on ``ENHANCE_TGN_DATA`` and the TGN
    [enhance-tgn] trained there (``online_ms``: the online TGN explainer's
    ms a step, [explain]). Returns (launches, numbers)."""
    import math
    import shutil
    from tempme_tpu_torch import cli
    from tempme_tpu_torch.data.cache import cache_to_inputs
    from tempme_tpu_torch.data.events import (load_dataset, shuffled_events,
                                              split_events)
    from tempme_tpu_torch.train import loops
    ds = load_dataset(ENHANCE_TGN_DATA, ds_dir)
    cache_dir = os.path.join(work, "cache")
    kernels = explain_kernels()
    n_batches = {m: math.ceil(len(e) / CACHE_BATCH)
                 for m, e in (("train", ds.train), ("test", ds.test))}
    say(f"[cache] cli preprocess --data {ENHANCE_TGN_DATA}: the walk cache "
        f"of the train split ({len(ds.train)} events, train graph, "
        f"train-only negatives) and the test split ({len(ds.test)}, full "
        f"graph), batch {CACHE_BATCH}, {N_DEGREE} neighbours, 3 walk "
        f"continuations, negatives seeded from --seed {SEED}")
    for f in kernels.values():
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        report = cli.main(["preprocess", "--data", ENHANCE_TGN_DATA,
                           "--data_dir", ds_dir, "--out_dir", cache_dir,
                           "--seed", str(SEED)])
    wall = time.perf_counter() - t0
    launches = {"cache": {k: f.launches for k, f in kernels.items()}}
    for line in printed.getvalue().splitlines():
        say(f"    | {line}")
    batches = sum(n_batches.values())
    check_launches(launches["cache"],
                   {k: CACHE_PER_BATCH.get(k, 0) * batches for k in kernels})
    say(f"  launches {launches['cache']} for {batches} batches "
        f"({CACHE_PER_BATCH} a batch); main() {wall:.2f} s")
    numbers = {"cache": {f"{m}_{k}": v for m, r in report.items()
                         for k, v in r.items() if k != "path"}}
    for m, r in report.items():
        numbers["cache"][f"{m}_events_per_s"] = r["events"] / r["build_s"]
        say(f"  {m}: {r['events']} events built in {r['build_s']:.2f} s "
            f"({r['events'] / r['build_s']:.1f} events/s), the .npz "
            f"({r['bytes'] / 2 ** 20:.1f} MiB, {r['bytes'] / r['events']:.0f} "
            f"bytes an event) written in {r['write_s']:.2f} s")
    caches = check_cache_files(report, ds, n_batches)
    check_cache_batch_against_cpu(ds, dev, torch)
    mtimes = {p: os.stat(p).st_mtime_ns for p in glob.glob(
        os.path.join(cache_dir, "*.npz"))}

    base_ckpt = os.path.join(work, "enhance_tgn_base", "params")
    ckpt_dir = os.path.join(work, "cache_explain", "params")
    shutil.copytree(os.path.join(base_ckpt, "tgnn"),
                    os.path.join(ckpt_dir, "tgnn"))
    out = os.path.join(work, "cache_explain")
    say(f"[cache-explain] cli explain --use_cache on the TGN of "
        f"[enhance-tgn] (bf16 projections): one epoch at the explainer's "
        f"defaults (batch {EXPLAIN_BATCH}, 60 walks a side, out_dim 40, "
        f"hid_dim 64, dropout {DROPOUT}, Adam lr {LR}), train and test from "
        f"the cache of [cache], val online")
    steps = {"train": len(ds.train) // EXPLAIN_BATCH,
             "eval": math.ceil(len(ds.val) / EXPLAIN_BATCH),
             "cached_eval": math.ceil(len(ds.test) / EXPLAIN_BATCH),
             "null": min(50, len(split_events(
                 shuffled_events(ds.full, seed=SEED), ds.node_feat,
                 ds.edge_feat).test) // 10)}
    for f in kernels.values():
        f.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        best = cli.main(cache_explain_argv(ds_dir, ckpt_dir, cache_dir, out))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["cache-explain"] = {k: f.launches for k, f in kernels.items()}
    for line in printed.getvalue().splitlines():
        say(f"    | {line}")
    if "building walk cache" in printed.getvalue():
        raise AssertionError("--use_cache rebuilt the cache of [cache]")
    check_launches(launches["cache-explain"], {
        k: sum(CACHE_EXPLAIN_PER_STEP[p][k] * c for p, c in steps.items())
        for k in kernels})
    say(f"  launches {launches['cache-explain']} for {steps}; per step "
        f"{CACHE_EXPLAIN_PER_STEP}")
    tags = read_metrics(out)
    losses = tags["Train/step_loss"]
    if len(losses) != steps["train"] or not all(map(math.isfinite, losses)):
        raise AssertionError("a cached explainer loss is missing or not "
                             "finite")
    eps = tags["Train/events_per_s"][0]
    nums = dict(train_ms_per_step=EXPLAIN_BATCH / eps * 1e3,
                events_per_s=eps,
                cache_slice_ms_per_step=tags[
                    "Train/cache_slice_ms_per_step"][0],
                online_train_ms_per_step=online_ms,
                loss_first=losses[0], loss_last=losses[-1],
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                wall_s=wall, best_val=best)
    for split in ("Val", "Test"):
        for key in ("aps", "auc", "acc", "fid_prob", "fid_logit", "r_aps",
                    "r_auc", "r_acc", "r_prob", "r_logit"):
            nums[f"{split.lower()}_{key}"] = tags[f"{split}/{key}"][0]
    for key in ("val_aps", "test_aps", "val_r_aps", "test_r_aps", "best_val"):
        if not 0.0 <= nums[key] <= 1.0:
            raise AssertionError(f"{key} {nums[key]} outside [0, 1]")
    for key in ("test_fid_prob", "test_fid_logit", "test_r_prob",
                "test_r_logit"):
        if not math.isfinite(nums[key]):
            raise AssertionError(f"{key} is not finite")
    numbers["cache-explain"] = nums
    say(f"  {steps['train']} steps: {nums['train_ms_per_step']:.3f} ms/step "
        f"from the cache (of which host slicing and copying "
        f"{nums['cache_slice_ms_per_step']:.3f}), online [explain] "
        f"{online_ms:.3f} ms/step; loss {losses[0]:.6f} -> {losses[-1]:.6f}; "
        f"val AP {nums['val_aps']:.6f}, test AP {nums['test_aps']:.6f}, test "
        f"fid_prob {nums['test_fid_prob']:.6f}, fid_logit "
        f"{nums['test_fid_logit']:.6f}; 16-ratio sweep on test: APS "
        f"{nums['test_r_aps']:.6f}, AUC {nums['test_r_auc']:.6f}, ACC "
        f"{nums['test_r_acc']:.6f}, prob {nums['test_r_prob']:.6f}, logit "
        f"{nums['test_r_logit']:.6f}; peak {nums['peak_gib']:.3f} GiB; main() "
        f"{wall:.2f} s with loading the cache, the null model and eval")

    say("  a second call (--eval_only) reuses the cache files")
    with contextlib.redirect_stdout(io.StringIO()):
        ev = cli.main(cache_explain_argv(ds_dir, ckpt_dir, cache_dir, out,
                                         "--eval_only"))
    if {p: os.stat(p).st_mtime_ns for p in mtimes} != mtimes or \
            len(glob.glob(os.path.join(cache_dir, "*.npz"))) != 2:
        raise AssertionError("the cache files changed")
    with open(os.path.join(out, "results",
                           f"explainer_tgn_{ENHANCE_TGN_DATA}.json")) as f:
        saved = json.load(f)
    worst = max(abs(ev[k] - saved[k]) for k in ev)
    if not worst <= 1e-6:
        raise AssertionError(f"--eval_only gave {ev}, the run saved {saved}")
    say(f"  files unchanged; the saved explainer's test metrics reproduced "
        f"from the test cache (max difference {worst:.3e})")

    say(f"[cache-reference] one cached explainer train step (batch "
        f"{EXPLAIN_BATCH}, dropout {DROPOUT}, the same cached inputs and "
        f"draws) on the card against the CPU, the base at float32, with "
        f"[explain-reference]'s tolerances")
    cpu = torch.device("cpu")
    tc, _ = explainer_steps_on(cpu, ds, ckpt_dir, torch.float32, "tgn",
                               ENHANCE_TGN_DATA)
    tg, _ = explainer_steps_on(dev, ds, ckpt_dir, torch.float32, "tgn",
                               ENHANCE_TGN_DATA)
    idx = loops.epoch_order(len(ds.train), EXPLAIN_BATCH, True, SEED + 1)[0]
    batch = loops.Batch(*(torch.from_numpy(x[idx]) for x in (
        ds.train.src, ds.train.dst, ds.train.ts, ds.train.e_idx)),
        mask=torch.ones(EXPLAIN_BATCH, dtype=torch.bool))
    gen = torch.Generator()
    gen.manual_seed(SEED + 7)
    for f in kernels.values():
        f.launches = 0
    compare_explainer_train_steps(
        tc, tg, batch, explainer_draws(tc, gen, sample=False), dev,
        cache_to_inputs(caches["train"], idx, N_DEGREE, cpu))
    if any(kernels[k].launches for k in _NO_SAMPLING):
        raise AssertionError("a cached step launched a sampling kernel")
    return launches, numbers


def pipeline_phase(work, ds_dir, torch):
    """[pipeline]: ``cli pipeline`` for a GraphMixer on ``CUT_DATA``, one
    epoch a stage, in a scratch working directory with ``TEMPME_DATA_DIR``
    set; then ``cli validate``. Returns the stages' numbers."""
    import math
    from tempme_tpu_torch import cli
    cwd = os.path.join(work, "pipeline_cwd")
    os.makedirs(cwd)
    argv = ["pipeline", "--data", CUT_DATA, "--base_types", "graphmixer",
            "--n_epoch_base", "1", "--n_epoch_exp", "1", "--n_epoch_enh",
            "1"]
    say(f"[pipeline] cli {' '.join(argv)} (learn-base: 2 mixer blocks, "
        f"batch {MIXER_BATCH}; explain and enhance: batch {EXPLAIN_BATCH}), "
        f"in a scratch working directory, TEMPME_DATA_DIR set; then cli "
        f"validate")
    old_cwd, old_env = os.getcwd(), os.environ.get("TEMPME_DATA_DIR")
    os.chdir(cwd)
    os.environ["TEMPME_DATA_DIR"] = ds_dir
    printed = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            results = cli.main(argv)
        wall = time.perf_counter() - t0
        for line in printed.getvalue().splitlines():
            if line.startswith("[pipeline]") or line.startswith("epoch"):
                say(f"    | {line}")
        r = results["graphmixer"]
        if "error" in r or cli.exit_code("pipeline", results) != 0:
            raise AssertionError(f"a pipeline stage failed: {r}")
        for stage in ("base_ap", "explainer_score", "enhance_ap"):
            if not (isinstance(r[stage], float) and math.isfinite(r[stage])
                    and 0.0 <= r[stage] <= 1.0):
                raise AssertionError(f"pipeline {stage} {r[stage]}")
        for f in (f"params_torch/tgnn/graphmixer_{CUT_DATA}.pt",
                  f"params_torch/explainer/graphmixer/{CUT_DATA}.pt",
                  f"params_torch/enhance/graphmixer/{CUT_DATA}.pt",
                  f"results_torch/enhance_graphmixer_{CUT_DATA}.json"):
            if not os.path.exists(f):
                raise AssertionError(f"the pipeline wrote no {f}")
        say(f"  base test AP {r['base_ap']:.6f}, explainer val score "
            f"{r['explainer_score']:.6f}, enhance test AP "
            f"{r['enhance_ap']:.6f}; {wall:.2f} s")
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = cli.main(["validate", "--data", CUT_DATA])
        for line in printed.getvalue().splitlines():
            say(f"    | {line}")
        if rc != 0:
            raise AssertionError(f"cli validate returned {rc}")
    finally:
        os.chdir(old_cwd)
        if old_env is None:
            os.environ.pop("TEMPME_DATA_DIR", None)
        else:
            os.environ["TEMPME_DATA_DIR"] = old_env
    return dict(r, wall_s=wall)


VARIANT_EVENTS = 5_000
VARIANT_DATA = "wikishape5k"
VARIANT_EXPLAIN_RESUME_STEP = 20     # [variants-explain]'s checkpoint step
# the drivers' TGN and TGAT variant flags, one run each ([tgn-variants],
# [tgat-variants]); (a) of the TGN is the one the explainer explains, (b)
# the one enhance trains
TGN_VARIANTS = {
    "a": ("--memory_updater", "rnn", "--aggregator", "mean",
          "--message_function", "identity"),
    "b": ("--embedding_module", "identity"),
    "c": ("--embedding_module", "time")}
TGAT_VARIANTS = {
    "a": ("--attn_mode", "map"),
    "b": ("--agg_method", "lstm", "--use_time", "pos"),
    "c": ("--agg_method", "mean", "--use_time", "empty")}
_NO_KERNEL = dict(sample_rows=0, attend=0, attend_drop=0, attend_bwd=0)
# launches per step: a graph-attention TGN samples 3 sides x 2 hops and
# embeds 3 sides x 2 layers (the training form and its backward in a train
# step, the eval form in an eval step); the identity and time embeddings
# read no support, so they sample none and run no attention; a TGAT variant
# samples 3 sides x 3 hops, and its blocks (map attention, the pools) are
# plain PyTorch
VARIANT_PER_STEP = {
    ("tgn", "a"): {"train": dict(sample_rows=6, attend=0, attend_drop=6,
                                 attend_bwd=6),
                   "eval": dict(sample_rows=6, attend=6, attend_drop=0,
                                attend_bwd=0)},
    ("tgn", "b"): {"train": _NO_KERNEL, "eval": _NO_KERNEL},
    ("tgn", "c"): {"train": _NO_KERNEL, "eval": _NO_KERNEL}}
for _v in TGAT_VARIANTS:
    VARIANT_PER_STEP[("tgat", _v)] = {
        p: dict(_NO_KERNEL, sample_rows=9) for p in ("train", "eval")}
# map attention's query-side score is the same for every key of a query,
# so the softmax removes it: these gradients are zero in exact arithmetic
MAP_QUERY_SCORE = ("weight_map_q", "wq_node_transform.weight")


def variant_argv(ds_dir, out, base_type, flags, *extra):
    """``learn_base`` one epoch on ``VARIANT_DATA`` with a variant's flags:
    a TGN at batch 256, a TGAT at its defaults (3 layers, 2 heads, the
    deep-TGAT batch 32); 20 neighbours, dropout 0.1, Adam lr 1e-3."""
    argv = ["--data", VARIANT_DATA, "--data_dir", ds_dir,
            "--base_type", base_type, "--n_degree", str(N_DEGREE),
            "--n_epoch", "1", "--drop_out", str(DROPOUT), "--lr", str(LR),
            "--seed", str(SEED),
            "--out_dir", os.path.join(out, "params", "tgnn"),
            "--log_dir", os.path.join(out, "tb"),
            "--results_dir", os.path.join(out, "results"), *flags, *extra]
    if base_type == "tgn":
        argv += ["--bs", str(BATCH)]
    return argv


def variant_train(ds, ds_dir, out, dev, torch, base_type, name, flags):
    """One epoch of ``learn_base.main`` on a variant at full width on the
    card: finite losses, APs in [0, 1], the checkpoint and its meta (the
    variant's flags; a TGAT's ``pos_seq_len``, a TGN's time statistics),
    the stated launches per step, then ``--eval_only``: a TGAT's test
    metrics equal what its run wrote, a TGN's equal ``evaluate_tgn`` from
    the checkpoint's memory (its run's test came after val moved the
    memory), exactly. Returns (launches, numbers)."""
    import math
    from tempme_tpu_torch.data.events import compute_time_statistics
    from tempme_tpu_torch.ops.kernels.attend import (attend, attend_bwd,
                                                     attend_drop)
    from tempme_tpu_torch.ops.kernels.sample_rows import sample_rows
    from tempme_tpu_torch.train import learn_base
    kernels = {"sample_rows": sample_rows, "attend": attend,
               "attend_drop": attend_drop, "attend_bwd": attend_bwd}
    batch = BATCH if base_type == "tgn" else TGAT_BATCH
    per_step = VARIANT_PER_STEP[(base_type, name)]
    steps = {"train": len(ds.train) // batch,
             "eval": math.ceil(len(ds.val) / batch)
             + math.ceil(len(ds.test) / batch)}
    want = {k: sum(per_step[p][k] * n for p, n in steps.items())
            for k in kernels}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for f in kernels.values():
        f.launches = 0
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        test_ap = learn_base.main(variant_argv(ds_dir, out, base_type,
                                               flags))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    for line in printed.getvalue().splitlines():
        if not line.startswith("  saved"):
            say(f"    | {line}")
    say(f"  launches: {launches} for {steps['train']} train and "
        f"{steps['eval']} eval steps; per step {per_step}")
    check_launches(launches, want)
    tags = read_metrics(out)
    losses = tags["Train/step_loss"]
    if len(losses) != steps["train"] or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{base_type} ({name}): a train loss is "
                             f"missing or not finite")
    eps = tags["Train/events_per_s"][0]
    val_ap = tags["Val/ap"][0]
    for split, ap in (("val", val_ap), ("test", test_ap)):
        if not 0.0 <= ap <= 1.0:
            raise AssertionError(f"{base_type} ({name}) {split} AP {ap}")
    params = os.path.join(out, "params", "tgnn",
                          f"{base_type}_{VARIANT_DATA}.pt")
    results = os.path.join(out, "results",
                           f"base_{base_type}_{VARIANT_DATA}.json")
    for path in (params, params + ".json", params + ".train_state",
                 results):
        if not os.path.exists(path):
            raise AssertionError(f"missing {path}")
    with open(params + ".json") as f:
        meta = json.load(f)
    for flag, value in zip(flags[::2], flags[1::2]):
        if meta[flag[2:]] != value:
            raise AssertionError(f"meta {flag[2:]} {meta[flag[2:]]}")
    if (meta["node_dim"], meta["n_degree"]) != (172, N_DEGREE):
        raise AssertionError(f"checkpoint meta {meta}")
    if base_type == "tgat" and (meta["n_layer"], meta["pos_seq_len"]) != (
            3, 64):
        raise AssertionError(f"TGAT checkpoint meta {meta}")
    if base_type == "tgn":
        stats = ((0.0, 0.0), (1.0, 1.0))
        if meta["embedding_module"] == "time":
            stats = compute_time_statistics(ds.train)
        if (tuple(meta["mean_time_shift"]),
                tuple(meta["std_time_shift"])) != stats:
            raise AssertionError(f"TGN time statistics in the meta {meta}")
    numbers = dict(train_ms_per_step=batch / eps * 1e3, events_per_s=eps,
                   loss_first=losses[0], loss_last=losses[-1],
                   val_ap=val_ap, test_ap=test_ap, peak_gib=peak / 2 ** 30,
                   wall_s=wall, train_steps=steps["train"],
                   eval_steps=steps["eval"])
    say(f"  {steps['train']} steps: {numbers['train_ms_per_step']:.3f} "
        f"ms/step, {eps:.1f} events/s (the driver's epoch clock); loss "
        f"first {losses[0]:.6f}, last {losses[-1]:.6f}; val AP "
        f"{val_ap:.6f}, test AP {test_ap:.6f}; peak device memory "
        f"{peak / 2 ** 30:.3f} GiB; main() {wall:.2f} s")
    argv = variant_argv(ds_dir, out, base_type, flags)
    if base_type == "tgat":
        eval_only(argv, results, f"TGAT ({name})")
    else:
        check_tgn_eval_only(argv, params, ds, dev, f"TGN ({name})")
    return launches, numbers


def variant_steps_on(dev, ds, out, base_type, compute_dtype=None):
    """The train step of a variant run's train state (``out``) on ``dev``,
    a TGN's projections at ``compute_dtype`` (float32 by default; a TGAT
    variant's blocks are float32 whatever it is): the model rebuilt from
    its checkpoint's meta, the parameters, Adam state (and a TGN's memory)
    loaded. Returns (step, memory or None)."""
    import torch
    from tempme_tpu_torch.data.events import RandEdgeSampler
    from tempme_tpu_torch.data.graph import build_temporal_graph
    from tempme_tpu_torch.models.common import Features
    from tempme_tpu_torch.models.tgat import TGAT
    from tempme_tpu_torch.models.tgn import TGN, TGNMemoryState
    from tempme_tpu_torch.train import learn_tgn, loops
    from tempme_tpu_torch.utils.checkpoint import load_checkpoint
    path = os.path.join(out, "params", "tgnn",
                        f"{base_type}_{VARIANT_DATA}.pt")
    blob, _ = load_checkpoint(path + ".train_state", map_location="cpu")
    with open(path + ".json") as f:
        meta = json.load(f)
    g = build_temporal_graph(ds.train, ds.full.num_nodes, ds.full.num_edges,
                             device=dev)
    feats = Features(torch.from_numpy(ds.node_feat).to(dev),
                     torch.from_numpy(ds.edge_feat).to(dev))
    dims = (ds.node_feat.shape[1], ds.edge_feat.shape[1])
    if base_type == "tgn":
        model = TGN(*dims, ds.full.num_nodes, dropout=DROPOUT,
                    memory_updater=meta["memory_updater"],
                    aggregator=meta["aggregator"],
                    message_function=meta["message_function"],
                    embedding_type=meta["embedding_module"],
                    mean_time_shift=meta["mean_time_shift"],
                    std_time_shift=meta["std_time_shift"], device=dev,
                    compute_dtype=compute_dtype or torch.float32)
    else:
        model = TGAT(*dims, num_layers=3, dropout=DROPOUT,
                     agg_method=meta["agg_method"],
                     attn_mode=meta["attn_mode"], use_time=meta["use_time"],
                     pos_seq_len=meta["pos_seq_len"], remat=True, device=dev,
                     compute_dtype=torch.float32)
    model.load_state_dict(blob["params"])
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    opt.load_state_dict(copy.deepcopy(blob["opt_state"]))
    dst = torch.from_numpy(RandEdgeSampler([ds.train.src],
                                           [ds.train.dst]).dst_list).to(dev)
    if base_type == "tgat":
        return loops.make_base_train_step(model, g, feats, dst, 3, N_DEGREE,
                                          opt), None
    mem = TGNMemoryState(**{k: v.to(dev) for k, v in blob["memory"].items()})
    return learn_tgn.make_tgn_train_step(model, g, feats, dst, N_DEGREE,
                                         opt), mem


def check_variant_against_cpu(ds, out, dev, base_type, name):
    """One train step of a variant run's state on the card and on the CPU
    at float32, the same batch and draws (dropout 0.1 where the variant has
    dropout sites): ``compare_train_steps`` (map attention's query-side
    score parameters as exact zeros), the logits rtol 2e-4, atol 1e-5, a
    TGN's new memory the same (its flags exactly). Returns the logits'
    largest difference."""
    import torch
    from tempme_tpu_torch.train import loops
    cpu = torch.device("cpu")
    step_c, mem_c = variant_steps_on(cpu, ds, out, base_type)
    step_g, mem_g = variant_steps_on(dev, ds, out, base_type)
    bs = REF_BATCH if base_type == "tgn" else TGAT_REF_BATCH
    batch = loops.Batch(*(x[0] for x in loops.stack_batches(
        ds.train, bs, True, SEED + 1, cpu)))
    gen = torch.Generator(device=cpu)
    gen.manual_seed(SEED + 3)
    draws = step_c.draw(gen, bs)
    if base_type == "tgn":
        new_c, aux_c = step_c(mem_c, batch, draws)
        new_g, aux_g = step_g(mem_g, to_device(batch, dev),
                              to_device(draws, dev))
    else:
        aux_c = step_c(batch, draws)
        aux_g = step_g(to_device(batch, dev), to_device(draws, dev))
    torch.cuda.synchronize()
    what = f"{base_type.upper()} ({name}) train step"
    compare_train_steps(step_c, aux_c, step_g, aux_g, what,
                        exact_zero=MAP_QUERY_SCORE)
    err = 0.0
    for key in ("pos", "neg"):
        torch.testing.assert_close(aux_g[key].cpu(), aux_c[key], rtol=2e-4,
                                   atol=1e-5)
        err = max(err, (aux_g[key].cpu() - aux_c[key]).abs().max().item())
    if base_type == "tgn":
        for field, a, b in zip(new_c._fields, new_g, new_c):
            if a.dtype == torch.bool:
                if not torch.equal(a.cpu(), b):
                    raise AssertionError(f"{what}: memory {field} differs")
            else:
                torch.testing.assert_close(a.cpu(), b, rtol=2e-4, atol=1e-5)
    say(f"  {what}: logits agree to {err:.3e}"
        + ("; the new memory agrees" if base_type == "tgn" else ""))
    return err


def profile_variant(ds, out, dev, base_type, n_steps=10):
    """``n_steps`` train steps of a variant run's state as the driver runs
    them (a TGN's projections in bf16), traced."""
    import torch
    from tempme_tpu_torch.train import loops
    step, mem = variant_steps_on(dev, ds, out, base_type, torch.bfloat16)
    bs = BATCH if base_type == "tgn" else TGAT_BATCH
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 23)
    batches = loops.stack_batches(ds.train, bs, True, SEED + 4, dev)
    n_steps = min(n_steps, batches.src.shape[0])
    work = [(loops.Batch(*(x[i] for x in batches)), step.draw(gen, bs))
            for i in range(n_steps)]
    state = [mem]

    def run(i):
        if mem is None:
            step(*work[i])
        else:
            state[0], _ = step(state[0], *work[i])
    run(0)                                   # warm up off the window
    profile_steps(run, n_steps)


def refused_explain(ds_dir, ckpt_dir, out):
    """``python -m tempme_tpu_torch.train.temp_exp_main`` on a TGAT that is
    not attn/prod: it must exit non-zero with the refusal's message."""
    argv = [sys.executable, "-m", "tempme_tpu_torch.train.temp_exp_main",
            *explain_argv(ds_dir, ckpt_dir, out, base_type="tgat",
                          data=VARIANT_DATA)]
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    reason = "the explainer needs a TGAT with --agg_method attn"
    if proc.returncode == 0 or reason not in proc.stderr:
        raise AssertionError(f"temp_exp_main on TGAT (b) exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    said = next(line for line in proc.stderr.splitlines() if reason in line)
    say(f"  temp_exp_main --base_type tgat on TGAT (b) exited "
        f"{proc.returncode} in {time.perf_counter() - t0:.2f} s: {said}")


def check_sampler_modes(ds, dev, torch):
    """[sampler-modes]: exp-decay (``bias`` = 1 / the median gap between a
    node's consecutive train events, as the source side of
    ``compute_time_statistics`` takes them) and binary ``sample_neighbors``
    at Q 2,000, n 20 on the card against the CPU, the same Gumbels: ids,
    edge ids and timestamps bit for bit. Returns their numbers."""
    import numpy as np
    from tempme_tpu_torch.data.graph import build_temporal_graph
    from tempme_tpu_torch.ops import sampler as S
    q, n = 2000, N_DEGREE
    tr = ds.train
    order = np.lexsort((tr.ts, tr.src))
    same = tr.src[order][1:] == tr.src[order][:-1]
    gaps = np.diff(tr.ts[order].astype(np.float64))[same]
    bias = 1.0 / float(np.median(gaps[gaps > 0]))
    r = np.random.RandomState(SEED + 5)
    pick = r.randint(0, len(tr), q)
    nodes = np.where(r.rand(q) < 0.5, tr.src[pick], tr.dst[pick])
    nodes = torch.from_numpy(nodes.astype(np.int32))
    times = torch.from_numpy(tr.ts[pick].astype(np.float32))
    cpu = torch.device("cpu")
    g_c = build_temporal_graph(tr, ds.full.num_nodes, ds.full.num_edges,
                               device=cpu)
    g_g = build_temporal_graph(tr, ds.full.num_nodes, ds.full.num_edges,
                               device=dev)
    chunks = S.decay_chunks(g_c, nodes, times)
    gen = torch.Generator(device=cpu)
    gen.manual_seed(SEED + 6)
    gumbel = S.draw_gumbel(gen, chunks, q, n, cpu)
    gumbel_g, nodes_g, times_g = (x.to(dev) for x in (gumbel, nodes, times))
    numbers = dict(bias=bias, chunks=chunks, q=q, n=n)
    for method in ("multinomial", "binary"):
        def run(g, gu, no, ti):
            return S.sample_neighbors(g, gu, no, ti, n, bias=bias,
                                      sample_method=method)
        want = run(g_c, gumbel, nodes, times)
        got = run(g_g, gumbel_g, nodes_g, times_g)
        for field, a, b in zip(("node", "eid", "ts"), got, want):
            differ = (a.cpu() != b).any(dim=1).nonzero().flatten()
            if len(differ):
                raise AssertionError(
                    f"{method} sampling: {field} differs from the CPU in "
                    f"rows {differ[:20].tolist()} (of {len(differ)})")
        ms = eager_ms(lambda: run(g_g, gumbel_g, nodes_g, times_g))
        t0 = time.perf_counter()
        run(g_c, gumbel, nodes, times)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        valid = float((want[0] != 0).float().mean())
        numbers[method] = dict(card_ms=ms, cpu_ms=cpu_ms, filled=valid)
        say(f"  {method} (bias {bias:.6g}): ids, edge ids and timestamps "
            f"bit for bit equal to the CPU's over {chunks} chunks of 128; "
            f"{valid:.4f} of the slots filled; card {ms:.3f} ms, CPU "
            f"{cpu_ms:.1f} ms")
    return numbers


def variant_phases(work, ds_dir, dev, torch):
    """[variants-data], [tgn-variants], [tgat-variants],
    [variants-reference], [variants-explain] and [sampler-modes]. Returns
    (launches per path, numbers)."""
    from tempme_tpu_torch.data.events import load_dataset
    t0 = time.perf_counter()
    write_stream(ds_dir, VARIANT_DATA, VARIANT_EVENTS, trim_nodes=True)
    ds = load_dataset(VARIANT_DATA, ds_dir)
    say(f"[variants-data] the first {VARIANT_EVENTS} events of the stream "
        f"as ml_{VARIANT_DATA}, the node table trimmed to its "
        f"{ds.full.num_nodes} ids (written in "
        f"{time.perf_counter() - t0:.2f} s; train {len(ds.train)}, val "
        f"{len(ds.val)}, test {len(ds.test)} events), width 172")
    launches, numbers, outs = {}, {}, {}
    say(f"[tgn-variants] learn_base.main --base_type tgn, one epoch each at "
        f"batch {BATCH}, {N_DEGREE} neighbours, dropout {DROPOUT}, then "
        f"--eval_only: (a) {' '.join(TGN_VARIANTS['a'])}; (b) "
        f"{' '.join(TGN_VARIANTS['b'])}; (c) {' '.join(TGN_VARIANTS['c'])}")
    for base_type, variants in (("tgn", TGN_VARIANTS),
                                ("tgat", TGAT_VARIANTS)):
        if base_type == "tgat":
            say(f"[tgat-variants] learn_base.main --base_type tgat at its "
                f"defaults (3 layers, 2 heads, batch {TGAT_BATCH}), "
                f"{N_DEGREE} neighbours, dropout {DROPOUT}, one epoch each, "
                f"then --eval_only: (a) {' '.join(TGAT_VARIANTS['a'])}; (b) "
                f"{' '.join(TGAT_VARIANTS['b'])}; (c) "
                f"{' '.join(TGAT_VARIANTS['c'])}")
        tot = {}
        for name, flags in variants.items():
            say(f"  {base_type.upper()} ({name}) {' '.join(flags)}")
            out = os.path.join(work, f"variant_{base_type}_{name}")
            outs[(base_type, name)] = out
            got, numbers[f"{base_type}-{name}"] = variant_train(
                ds, ds_dir, out, dev, torch, base_type, name, flags)
            tot = {k: tot.get(k, 0) + v for k, v in got.items()}
        launches[f"{base_type}-variants"] = tot
    say(f"[variants-reference] one train step of each of the six runs on "
        f"the card against the CPU from its train state at float32 (batch "
        f"{REF_BATCH} for a TGN, {TGAT_REF_BATCH} for a 3-layer TGAT; "
        f"dropout {DROPOUT} where the variant has dropout sites): loss rtol "
        f"1e-4; logits rtol 2e-4, atol 1e-5; gradients rtol 1e-3, atol 1e-4 "
        f"of the tensor's largest; params after Adam rtol 1e-5, atol 1e-6 "
        f"where settled, within lr elsewhere; a TGN's memory rtol 2e-4, "
        f"atol 1e-5")
    numbers["reference_logit_err"] = max(
        check_variant_against_cpu(ds, out, dev, *key)
        for key, out in outs.items())
    say("[trace-variants] torch.profiler over 10 train steps of each run "
        "(not counted above)")
    for (base_type, name), out in outs.items():
        say(f"  {base_type.upper()} ({name})")
        profile_variant(ds, out, dev, base_type)
    say(f"[variants-explain] temp_exp_main.main on TGN (a) (one epoch, "
        f"batch {EXPLAIN_BATCH}, 60 walks a side); enhance_main.main on "
        f"TGN (b) (one epoch at its defaults); temp_exp_main on TGAT (b), "
        f"which must refuse")
    ckpt_a = os.path.join(outs[("tgn", "a")], "params")
    launches["variants-explain"], numbers["explain-tgn-a"], _, _ = explain(
        ds, ds_dir, ckpt_a, os.path.join(work, "variant_explain"), torch,
        data=VARIANT_DATA, resume_step=VARIANT_EXPLAIN_RESUME_STEP)
    launches["variants-enhance"], numbers["enhance-tgn-b"], _, _ = enhance(
        ds, ds_dir, os.path.join(outs[("tgn", "b")], "params"),
        os.path.join(work, "variant_enhance"), torch, "tgn",
        data=VARIANT_DATA, per_step=ENHANCE_PER_STEP["graphmixer"])
    refused_explain(ds_dir, os.path.join(outs[("tgat", "b")], "params"),
                    os.path.join(work, "variant_refused"))
    say(f"[sampler-modes] exp-decay and binary sample_neighbors at Q 2000, "
        f"n {N_DEGREE} on ml_{VARIANT_DATA}'s train graph, on the card "
        f"against the CPU with the same Gumbels: bit for bit")
    numbers["sampler-modes"] = check_sampler_modes(ds, dev, torch)
    return launches, numbers


TOOLS_EVENTS = 2_000                 # [explain-profile]'s cut, node table whole
TOOLS_DATA = "wikishape2k"
VIZ_SAMPLES = 6
PROFILE_STAGES = ("sample", "fwd", "fwd_drop", "embed", "memory", "fwdbwd",
                  "full", "sample_hop0", "sample_hop1")
_STEP_KERNELS = ("sample_rows", "attend", "attend_drop", "attend_bwd")
# launches of one call of each profile_step stage (2 layers, 3 sides)
PROFILE_LAUNCHES = {
    "sample": dict(sample_rows=6), "fwd": dict(attend=6),
    "fwd_drop": dict(attend_drop=6), "embed": dict(attend=6),
    "memory": dict(attend=6), "fwdbwd": dict(attend=6, attend_bwd=6),
    "full": dict(sample_rows=6, attend_drop=6, attend_bwd=6),
    "sample_hop0": dict(sample_rows=1), "sample_hop1": dict(sample_rows=1)}


def quiet(fn, *args, **kw):
    """``fn(*args, **kw)`` with its standard output captured; returns
    (result, the printed text)."""
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        out = fn(*args, **kw)
    return out, printed.getvalue()


def profile_step_phase(work, ds_dir):
    """[profile-step]: ``tools/profile_step.py`` on the wikipedia-shaped
    stream at its defaults (batch 256, 30 neighbours, 2 layers, 2 heads,
    dropout 0.1) with ``--trace``. Returns its numbers."""
    import math
    from tempme_tpu_torch.tools import profile_step
    from tempme_tpu_torch.utils import profiling
    trace_dir = os.path.join(work, "profile_step_trace")
    t0 = time.perf_counter()
    r, printed = quiet(profile_step.main, ["--data", DATA_NAME, "--data_dir",
                                           ds_dir, "--trace", trace_dir])
    wall = time.perf_counter() - t0
    say(f"  {printed.strip()}")
    for stage in PROFILE_STAGES:
        for key in (f"{stage}_ms", f"{stage}_host_ms"):
            if key in r and not (math.isfinite(r[key]) and r[key] > 0):
                raise AssertionError(f"profile_step {key} = {r.get(key)}")
        check_launches(r["launches"][stage], {
            k: PROFILE_LAUNCHES[stage].get(k, 0) for k in _STEP_KERNELS})
    trace = profiling.latest_trace(trace_dir)
    say(f"  {'stage':<12}{'device ms':>11}{'host ms':>11}  clock, launches "
        f"per call")
    for stage in PROFILE_STAGES:
        host = r.get(f"{stage}_host_ms")
        host = "-" if host is None else f"{host:.4f}"
        say(f"  {stage:<12}{r[stage + '_ms']:>11.4f}{host:>11}  "
            f"{r['clock'][stage]}, {PROFILE_LAUNCHES[stage]}")
    say(f"  {r['events_per_s_full']:.1f} events/s on the full step; trace "
        f"{os.path.basename(trace)} ({os.path.getsize(trace)} bytes); "
        f"{wall:.2f} s with loading")
    return r


def op_census_phase(work, torch):
    """[op-census]: ``tools/op_census.py --capture enron --steps 20`` (the
    Enron-shaped TGN train step, batch 256, 30 neighbours). Returns the
    categories."""
    from tempme_tpu_torch.tools import op_census
    from tempme_tpu_torch.tools.profile_step import KERNELS
    for f in KERNELS.values():
        f.launches = 0
    t0 = time.perf_counter()
    res, printed = quiet(op_census.main, [
        "--capture", "enron", "--steps", "20", "--trace_dir",
        os.path.join(work, "op_census"), "--out",
        os.path.join(work, "op_census.json")])
    wall = time.perf_counter() - t0
    for line in printed.splitlines():
        say(f"    | {line}")
    steps = 3 + res["meta"]["steps"]
    launches = {name: f.launches for name, f in KERNELS.items()}
    check_launches(launches, dict(sample_rows=6 * steps, attend=0,
                                  attend_drop=6 * steps,
                                  attend_bwd=6 * steps))
    total = sum(a["pct"] for a in res["categories"].values())
    if abs(total - 100.0) > 0.1:
        raise AssertionError(f"the census's shares sum to {total}")
    _, rows = op_census.parse_trace(res["meta"]["paths"], top_ops=10 ** 6)
    port = [r for r in rows if r["category"] == "port kernels"]
    for frag in ("sample_rows_kernel", "attend_kernel", "attend_bwd_kernel"):
        if not any(frag in r["op"] for r in port):
            raise AssertionError(f"no {frag} among the port's kernels: "
                                 f"{[r['op'] for r in port]}")
    say(f"  launches {launches} over {steps} steps (3 warm-up); shares sum "
        f"to {total:.6f}%; {wall:.2f} s")
    for r in port:
        say(f"    port kernel {r['occurrences']:5d}x "
            f"{r['self_time_us']:10.1f} us {r['op'][:80]}")
    return res["categories"]


def explain_profile_phase(work, ds_dir, train_ckpt, torch):
    """[explain-profile]: ``temp_exp_main --profile --n_epoch 2`` on the
    TGN of [train] over the stream's first TOOLS_EVENTS events (node table
    whole); the trace of epoch 1 holds the walk kernels."""
    import math
    from tempme_tpu_torch.data.events import (load_dataset, shuffled_events,
                                              split_events)
    from tempme_tpu_torch.tools import op_census
    from tempme_tpu_torch.train import temp_exp_main
    from tempme_tpu_torch.utils import profiling
    write_stream(ds_dir, TOOLS_DATA, TOOLS_EVENTS)
    ds = load_dataset(TOOLS_DATA, ds_dir)
    ckpt = explain_base_dir(work, train_ckpt, TOOLS_DATA, "profile_base")
    out = os.path.join(work, "explain_profile")
    kernels = explain_kernels()
    steps = {"train": 2 * (len(ds.train) // EXPLAIN_BATCH),
             "eval": 2 * (math.ceil(len(ds.val) / EXPLAIN_BATCH)
                          + math.ceil(len(ds.test) / EXPLAIN_BATCH)),
             "null": min(50, len(split_events(
                 shuffled_events(ds.full, seed=SEED), ds.node_feat,
                 ds.edge_feat).test) // 10)}
    want = {k: sum(EXPLAIN_PER_STEP[p][k] * n for p, n in steps.items())
            for k in kernels}
    for f in kernels.values():
        f.launches = 0
    t0 = time.perf_counter()
    _, printed = quiet(temp_exp_main.main, explain_argv(
        ds_dir, ckpt, out, "--n_epoch", "2", "--profile", data=TOOLS_DATA))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: f.launches for name, f in kernels.items()}
    for line in printed.splitlines():
        if line.startswith(("epoch", "profiler")):
            say(f"    | {line}")
    check_launches(launches, want)
    trace = profiling.latest_trace(os.path.join(out, "tb", "trace"))
    if f"profiler trace -> {trace}" not in printed:
        raise AssertionError("the driver did not print its trace's path")
    cats, rows = op_census.parse_trace([trace], top_ops=10 ** 6)
    total = sum(a["pct"] for a in cats.values())
    if abs(total - 100.0) > 0.1:
        raise AssertionError(f"the census's shares sum to {total}")
    port = [r for r in rows if r["category"] == "port kernels"]
    for frag in ("sample_union_kernel", "sample_masked_kernel",
                 "w2e_fwd_kernel", "w2e_bwd_kernel"):
        if not any(frag in r["op"] for r in port):
            raise AssertionError(f"no {frag} in the --profile trace: "
                                 f"{[r['op'] for r in port]}")
    say(f"  launches {launches} for {steps} steps (2 epochs; the null "
        f"model once); trace {os.path.basename(trace)} "
        f"({os.path.getsize(trace)} bytes); main() {wall:.2f} s")
    for cat, a in sorted(cats.items(), key=lambda kv: -kv[1]["self_time_us"]):
        say(f"    {cat:<22}{a['self_time_us']:12.1f} us {a['pct']:7.2f}% "
            f"{a['occurrences']:7d} ops")
    for r in port:
        say(f"    port kernel {r['occurrences']:5d}x "
            f"{r['self_time_us']:10.1f} us {r['op'][:80]}")
    return launches, cats


def visualize_phase(work, ds_dir, ckpt_dir, dev, torch):
    """[visualize]: ``cli visualize`` on [explain]'s saved TGN explainer;
    then the plotted arrays of one batch on the card against the CPU, from
    the same checkpoint and draws."""
    import numpy as np
    from tempme_tpu_torch import cli
    from tempme_tpu_torch.data.events import RandEdgeSampler, load_dataset
    from tempme_tpu_torch.data.graph import build_temporal_graph
    from tempme_tpu_torch.models.common import Features
    from tempme_tpu_torch.ops import sampler as S
    from tempme_tpu_torch.tools import visualize
    from tempme_tpu_torch.train import loops
    from tempme_tpu_torch.train.temp_exp_main import (N_WALK_CONT,
                                                      ExplainerDraws)
    out = os.path.join(work, "visualize")
    kernels = explain_kernels()
    for f in kernels.values():
        f.launches = 0
    t0 = time.perf_counter()
    rc, printed = quiet(cli.main, [
        "visualize", "--data", EXPLAIN_DATA, "--data_dir", ds_dir,
        "--base_type", "tgn", "--ckpt_dir", ckpt_dir, "--out_dir", out,
        "--n_samples", str(VIZ_SAMPLES)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: f.launches for name, f in kernels.items()}
    pngs = sorted(p for p in os.listdir(out) if p.endswith(".png"))
    say(f"  {printed.strip()}: {pngs} in {wall:.2f} s; launches {launches}")
    if rc != 0 or len(pngs) != VIZ_SAMPLES + 1:
        raise AssertionError(f"cli visualize exited {rc} with {pngs}")
    walk_path = ("sample_rows", "sample_union", "sample_masked",
                 "walk_to_edge")          # each launched, attention not
    check_launches({k: min(launches[k], 1) for k in walk_path}
                   | {"attend": launches["attend"]},
                   dict.fromkeys(walk_path, 1) | {"attend": 0})

    ds = load_dataset(EXPLAIN_DATA, ds_dir)
    cpu = torch.device("cpu")
    dst = RandEdgeSampler([ds.test.src], [ds.test.dst], seed=SEED).dst_list
    batch = loops.Batch(*(x[0] for x in loops.stack_batches(
        ds.test, EXPLAIN_BATCH, True, SEED, cpu)))
    gen = torch.Generator(device=cpu)
    gen.manual_seed(SEED + 13)
    draws = ExplainerDraws(
        loops.draw_support(gen, EXPLAIN_BATCH, 2, N_DEGREE, len(dst), cpu),
        tuple(S.draw_walks(gen, EXPLAIN_BATCH, N_DEGREE, N_WALK_CONT, cpu)
              for _ in range(3)))
    got = []
    for d in (dev, cpu):
        g = build_temporal_graph(ds.full, ds.full.num_nodes,
                                 ds.full.num_edges, device=d)
        feats = Features(torch.from_numpy(ds.node_feat).to(d),
                         torch.from_numpy(ds.edge_feat).to(d))
        explainer = visualize.load_explainer(ckpt_dir, "tgn", EXPLAIN_DATA, d)
        got.append(visualize.explain_samples(
            explainer, feats, g, to_device(batch, d),
            torch.from_numpy(dst).to(d), N_DEGREE, to_device(draws, d),
            EXPLAIN_BATCH))
    (card, card_counts), (ref, ref_counts) = got
    if not np.array_equal(card_counts, ref_counts):
        raise AssertionError("motif counts differ from the CPU")
    worst = 0.0
    for (e, imp, t), (e_c, imp_c, t_c) in zip(card, ref):
        if not np.isfinite(imp).all():
            raise AssertionError("an importance is not finite")
        if not (np.array_equal(e, e_c) and np.array_equal(t, t_c)):
            raise AssertionError("support edges differ from the CPU")
        np.testing.assert_allclose(imp, imp_c, rtol=2e-4, atol=1e-5)
        worst = max(worst, float(np.abs(imp - imp_c).max()))
    filled = float(np.mean([(e > 0).mean() for e, _, _ in card]))
    say(f"  {len(card)} samples of batch {EXPLAIN_BATCH}: edge ids and "
        f"motif counts equal to the CPU's, importances within {worst:.3e} "
        f"(rtol 2e-4, atol 1e-5); {filled:.4f} of the support slots filled")
    return launches


def debug_phase(work, ds_dir, torch):
    """[debug]: one ``learn_base`` epoch of the TGN under TEMPME_DEBUG=1 on
    ``ml_{VARIANT_DATA}`` (written by [variants-data])."""
    from tempme_tpu_torch.train import learn_base
    out = os.path.join(work, "debug")
    argv = train_argv(ds_dir, out)
    argv[argv.index("--data") + 1] = VARIANT_DATA
    os.environ["TEMPME_DEBUG"] = "1"
    t0 = time.perf_counter()
    try:
        ap, printed = quiet(learn_base.main, argv)
    finally:
        del os.environ["TEMPME_DEBUG"]
    wall = time.perf_counter() - t0
    mode = "[debug] TEMPME_DEBUG=1"
    lines = [line for line in printed.splitlines()
             if line.startswith((mode, "epoch"))]
    for line in lines:
        say(f"    | {line}")
    if not lines or not lines[0].startswith(mode) or not 0.0 <= ap <= 1.0:
        raise AssertionError(f"the debug run printed {printed[-2000:]}")
    if torch.is_anomaly_enabled():
        raise AssertionError("anomaly mode outlived the debug run")
    say(f"  one epoch with anomaly detection and the epoch-end finiteness "
        f"checks: test AP {ap:.6f}, {wall:.2f} s")


def native_phase(ds_dir):
    """[native]: build the host library with g++; ``load_csv`` of the
    stream's CSV equals the numpy loader, and ``HostGraph``'s picks lie
    before their cut times, sorted."""
    import numpy as np
    from tempme_tpu_torch.data.events import load_csv_events
    from tempme_tpu_torch.utils import native
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native host runtime did not build")
    build_s = time.perf_counter() - t0
    path = os.path.join(ds_dir, f"ml_{DATA_NAME}.csv")
    t0 = time.perf_counter()
    cols = native.load_csv(path)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ev = load_csv_events(path)
    numpy_s = time.perf_counter() - t0
    for name, a, b in zip(("src", "dst", "ts", "label", "e_idx"), cols,
                          (ev.src, ev.dst, ev.ts, ev.label, ev.e_idx)):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"load_csv's {name} differs from numpy's")
    g = native.HostGraph(ev.src, ev.dst, ev.e_idx, ev.ts, ev.num_nodes,
                         ev.num_edges)
    r = np.random.RandomState(SEED)
    q = 2000
    nodes = r.randint(1, ev.num_nodes, q).astype(np.int32)
    times = r.uniform(0, float(ev.ts.max()) + 1, q).astype(np.float32)
    t0 = time.perf_counter()
    on, oe, ot = g.sample_neighbors(nodes, times, N_DEGREE, seed=SEED)
    sample_s = time.perf_counter() - t0
    picked = oe > 0
    if not (ot[picked] < np.broadcast_to(times[:, None], ot.shape)[picked]
            ).all():
        raise AssertionError("a host pick is not before its cut time")
    if not (np.diff(ot, axis=1) >= 0).all() or \
            (on[~picked] != 0).any():
        raise AssertionError("host picks are not sorted or not padded")
    say(f"  built in {build_s:.2f} s; load_csv of {len(ev)} events equal to "
        f"numpy's ({native_s * 1e3:.1f} ms against {numpy_s * 1e3:.1f} "
        f"ms); {q} x {N_DEGREE} host picks before their cuts, sorted "
        f"({picked.mean():.4f} filled, {sample_s * 1e3:.2f} ms)")


def tool_phases(work, ds_dir, train_ckpt, explain_ckpt, dev, torch):
    """[profile-step], [op-census], [explain-profile], [visualize],
    [debug] and [native]. Returns (launches per path, numbers)."""
    t0 = time.perf_counter()
    say("[profile-step] tools/profile_step.py on the wikipedia-shaped "
        "stream (batch 256, 30 neighbours, 2 layers, 2 heads, dropout 0.1): "
        "each stage of the TGN train step timed by itself, then --trace "
        "over five full steps")
    numbers = {"profile_step": profile_step_phase(work, ds_dir)}
    say("[op-census] tools/op_census.py --capture enron --steps 20 (the "
        "Enron-shaped TGN train step, batch 256, 30 neighbours)")
    numbers["op_census"] = op_census_phase(work, torch)
    say(f"[explain-profile] temp_exp_main --profile --n_epoch 2 on the TGN "
        f"of [train] over the stream's first {TOOLS_EVENTS} events "
        f"(ml_{TOOLS_DATA}, node table whole), batch {EXPLAIN_BATCH}")
    launches = {}
    launches["explain-profile"], numbers["explain_profile"] = \
        explain_profile_phase(work, ds_dir, train_ckpt, torch)
    say(f"[visualize] cli visualize on [explain]'s TGN explainer "
        f"(ml_{EXPLAIN_DATA}, {VIZ_SAMPLES} samples); one batch's plotted "
        f"arrays on the card against the CPU")
    launches["visualize"] = visualize_phase(work, ds_dir, explain_ckpt, dev,
                                            torch)
    say(f"[debug] learn_base.main --base_type tgn under TEMPME_DEBUG=1, one "
        f"epoch on ml_{VARIANT_DATA}")
    debug_phase(work, ds_dir, torch)
    say("[native] the native host runtime (g++), on the stream's CSV")
    native_phase(ds_dir)
    numbers["wall_s"] = time.perf_counter() - t0
    say(f"  the tools' phases took {numbers['wall_s']:.1f} s")
    return launches, numbers


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
    walk_rows, walk_errs = check_walk_kernels(ds, g, torch, dev)
    say("[kernels] at the TGAT paths' shapes (3 layers, d_k 258, hop 3) and "
        "C3's sizes")
    tgat_rows, tgat_errs = check_tgat_kernels(g, torch, dev)
    say("[kernels] at the walk cache's build shapes (batch 128)")
    cache_rows = check_cache_kernels(ds, g, torch, dev)

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
        "the CPU at float32 (rtol 2e-4, atol 1e-5), then at bf16, the "
        "default (rtol 5e-2, atol 5e-2: each side rounds its projections "
        "to bf16 after float32 sums taken in another order, a bf16 ulp is "
        "4e-3, and the differences pass through two layers and the memory)")
    err32 = check_against_cpu(ds, step, mem, dev, torch.float32, 2e-4, 1e-5)
    err16 = check_against_cpu(ds, step, mem, dev, torch.bfloat16, 5e-2, 5e-2)
    say(f"  logits and memory agree: max abs err {err32:.3e} at float32, "
        f"{err16:.3e} at bf16")
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
        check_train_against_cpu(ds, os.path.join(work, "train"), dev)
        say(f"[dp] data-parallel TGN training (parallel/): the sharded step "
            f"from the [train] checkpoint at width 172, batch {BATCH}, "
            f"{N_DEGREE} neighbours, dropout {DROPOUT}")
        dp_launches, dp_numbers = dp_phase(ds, os.path.join(work, "train"),
                                           dev, torch)
        meshes = ", ".join(f"{'x'.join(map(str, m))} ({k} steps)"
                           for m, k in SP_TP_MESHES)
        say(f"[sp-tp] the TGN step on the sp and tp mesh axes (parallel/): "
            f"meshes {meshes} from the [train] checkpoint at width 172, "
            f"float32, batch "
            f"{BATCH}, {N_DEGREE} neighbours, dropout {DROPOUT}; the ranks "
            f"share this card over gloo with CUDA tensors")
        sptp_launches, sptp_numbers = sp_tp_phase(
            ds, os.path.join(work, "train"), dev, torch)
        from tempme_tpu_torch.data.events import load_dataset
        t0 = time.perf_counter()
        write_stream(ds_dir, CUT_DATA, CUT_EVENTS)
        ds30 = load_dataset(CUT_DATA, ds_dir)
        cut_s = time.perf_counter() - t0
        ckpt_dir = explain_base_dir(work, os.path.join(work, "train",
                                                       "params"))
        say(f"[explain] temp_exp_main.main on the frozen TGN of [train] "
            f"(load_base, bf16 projections) over the first {CUT_EVENTS} "
            f"events of the stream, ml_{EXPLAIN_DATA} (written in "
            f"{cut_s:.2f} s; train {len(ds30.train)}, val {len(ds30.val)}, "
            f"test {len(ds30.test)} events): one epoch, batch "
            f"{EXPLAIN_BATCH}, {N_DEGREE} neighbours, 3 walk continuations "
            f"(60 walks, 180 walk event slots a side), out_dim 40, hid_dim "
            f"64, dropout {DROPOUT}, Adam lr {LR}, then val and test with "
            f"fidelity and the 16-ratio sweep")
        explain_launches, explain_numbers, results_path, snapshot = explain(
            ds30, ds_dir, ckpt_dir, os.path.join(work, "explain"), torch,
            data=EXPLAIN_DATA)
        say(f"[explain-resume] --resume from the state of a run stopped "
            f"right after its --ckpt_every_steps {EXPLAIN_RESUME_STEP} "
            f"checkpoint, to the end of the epoch")
        t0 = time.perf_counter()
        explain_resume(ds_dir, ckpt_dir,
                       os.path.join(work, "explain_resume"), snapshot,
                       data=EXPLAIN_DATA)
        say(f"  resumed and finished in {time.perf_counter() - t0:.2f} s")
        say("[explain-eval-only] --eval_only on the saved explainer")
        explain_eval_only(ds_dir, ckpt_dir, os.path.join(work, "explain_eval"),
                          results_path, data=EXPLAIN_DATA)
        say(f"[explain-reference] one explainer train step (batch "
            f"{EXPLAIN_BATCH}, dropout {DROPOUT}, injected draws) and one "
            f"eval step on the card against the CPU, the base at float32: "
            f"loss rtol 1e-4; gradients rtol 1e-3, atol 1e-4 of the tensor's "
            f"largest; params after Adam rtol 1e-5, atol 1e-6 where the "
            f"gradient is settled (1e-4 of the largest and 1e-5), within lr "
            f"elsewhere; logits and the 16-ratio sweep rtol 2e-4, atol 1e-5")
        check_explainer_against_cpu(ds30, ckpt_dir, dev, data=EXPLAIN_DATA)
        say("[trace-explain] torch.profiler over 20 explainer train steps at "
            f"batch {EXPLAIN_BATCH} (not counted above)")
        profile_explainer(ds30, ckpt_dir, dev, data=EXPLAIN_DATA)
        say("[trace-train] torch.profiler over 20 train steps at batch "
            f"{BATCH} (not counted above)")
        profile_training(ds, os.path.join(work, "train"), dev)

        tgat_out = os.path.join(work, "tgat")
        say(f"[tgat-train] learn_base.main at its default flags (TGAT, 3 "
            f"layers, 2 heads, the deep-TGAT batch {TGAT_BATCH}, dropout "
            f"{DROPOUT}, Adam lr {LR}), {N_DEGREE} neighbours, width 172 "
            f"(d_k 258), one epoch on ml_{TGAT_DATA}, the stream's first "
            f"{TGAT_EVENTS} events")
        write_stream(ds_dir, TGAT_DATA, TGAT_EVENTS)
        dst = load_dataset(TGAT_DATA, ds_dir)
        tgat_launches, _, tgat_numbers, tgat_snap = tgat_train(
            dst, ds_dir, tgat_out, torch)
        say(f"[tgat-resume] --resume from the state of a run stopped right "
            f"after its --ckpt_every_steps {TGAT_CKPT_STEP} checkpoint, to "
            f"the end of the epoch")
        t0 = time.perf_counter()
        tgat_resume(ds_dir, os.path.join(work, "tgat_resume"), tgat_snap)
        say(f"  resumed and finished in {time.perf_counter() - t0:.2f} s")
        say(f"[tgat-reference] one TGAT train step (batch {TGAT_REF_BATCH}, "
            f"width 172, d_k 258, dropout {DROPOUT}) on the card against "
            f"the CPU from the trained checkpoint at float32 (loss rtol "
            f"1e-4; gradients rtol 1e-3, atol 1e-4 of the tensor's largest; "
            f"params after Adam rtol 1e-5, atol 1e-6 where settled, within "
            f"lr elsewhere); the committed uslegis TGAT's contrast at "
            f"float32 and bf16")
        check_tgat_train_against_cpu(dst, tgat_out, dev)
        check_uslegis_tgat(dst, dev)
        tgat_ckpt = os.path.join(tgat_out, "params")
        say(f"[tgat-explain] temp_exp_main.main --base_type tgat on the "
            f"frozen TGAT of [tgat-train] (3-hop supports, bf16 "
            f"projections): one epoch, batch {EXPLAIN_BATCH}, {N_DEGREE} "
            f"neighbours, 60 walks a side, out_dim 40, hid_dim 64, 8 "
            f"heads, dropout {DROPOUT}, Adam lr {LR}, then val and test "
            f"with fidelity and the 16-ratio sweep in 4 chunks of 4")
        tx_launches, tx_numbers, tx_results, tx_snap = explain(
            dst, ds_dir, tgat_ckpt, os.path.join(work, "tgat_explain"),
            torch, base_type="tgat", data=TGAT_DATA,
            per_step=TGAT_EXPLAIN_PER_STEP,
            resume_step=TGAT_EXPLAIN_RESUME_STEP)
        say(f"  --resume from the state of a run stopped right after its "
            f"--ckpt_every_steps {TGAT_EXPLAIN_RESUME_STEP} checkpoint")
        t0 = time.perf_counter()
        explain_resume(ds_dir, tgat_ckpt,
                       os.path.join(work, "tgat_explain_resume"), tx_snap,
                       base_type="tgat", data=TGAT_DATA,
                       resume_step=TGAT_EXPLAIN_RESUME_STEP)
        say(f"  resumed and finished in {time.perf_counter() - t0:.2f} s")
        say("  --eval_only on the saved TGAT explainer")
        explain_eval_only(ds_dir, tgat_ckpt,
                          os.path.join(work, "tgat_explain_eval"),
                          tx_results, base_type="tgat", data=TGAT_DATA)
        say(f"[trace-tgat] torch.profiler over 20 TGAT train steps at batch "
            f"{TGAT_BATCH} (not counted above)")
        profile_tgat_training(dst, tgat_out, dev)
        say(f"[dp-explain] the explainer's data-parallel step (parallel/) "
            f"from the checkpoints of [explain] and [tgat-explain] at width "
            f"172, batch {EXPLAIN_BATCH}, {N_DEGREE} neighbours, dropout "
            f"{DROPOUT}")
        dpx_launches, dpx_numbers = dp_explain_phase(ds30, ckpt_dir,
                                                     tgat_ckpt, dev, torch)
        mixer_launches, mx_launches, mixer_numbers, mx_numbers = \
            graphmixer_phases(work, ds_dir, ds30, dev, torch)
        enhance_launches, enhance_numbers = enhance_phases(
            work, ds_dir, ds30, dev, torch)
        say(f"[dp-enhance] enhance's data-parallel step (parallel/) with "
            f"the TGN of [enhance-tgn]'s base and the GraphMixer of "
            f"[mixer-train], a fresh seeded predictor, width 172, batch "
            f"{ENHANCE_BATCH}, {N_DEGREE} neighbours, dropout {DROPOUT}")
        dph_launches, dph_numbers = dp_enhance_phase(
            load_dataset(ENHANCE_TGN_DATA, ds_dir), os.path.join(
                work, "enhance_tgn_base", "params", "tgnn",
                f"tgn_{ENHANCE_TGN_DATA}.pt"), ds30,
            os.path.join(work, "mixer", "params", "tgnn",
                         f"graphmixer_{MIXER_DATA}.pt"), dev, torch)
        cache_launches, cache_numbers = cache_phases(
            work, ds_dir, dev, torch, explain_numbers["train_ms_per_step"])
        pipeline_numbers = pipeline_phase(work, ds_dir, torch)
        variant_launches, variant_numbers = variant_phases(
            work, ds_dir, dev, torch)
        tool_launches, tool_numbers = tool_phases(
            work, ds_dir, os.path.join(work, "train", "params"), ckpt_dir,
            dev, torch)
    say(f"  training cell: {json.dumps(numbers)}")
    say(f"  dp cell (2 ranks on one card): {json.dumps(dp_numbers)}")
    say(f"  sp-tp cells (2 or 4 ranks on one card): "
        f"{json.dumps(sptp_numbers)}")
    say(f"  dp-explain cell (2 ranks on one card): "
        f"{json.dumps(dpx_numbers)}")
    say(f"  dp-enhance cell (2 ranks on one card): "
        f"{json.dumps(dph_numbers)}")
    say(f"  explainer cell: {json.dumps(explain_numbers)}")
    say(f"  TGAT training cell: {json.dumps(tgat_numbers)}")
    say(f"  TGAT explainer cell: {json.dumps(tx_numbers)}")
    say(f"  GraphMixer training cell: {json.dumps(mixer_numbers)}")
    say(f"  GraphMixer explainer cell: {json.dumps(mx_numbers)}")
    for path, nums in {**enhance_numbers, **cache_numbers}.items():
        say(f"  {path} cell: {json.dumps(nums)}")
    say(f"  pipeline cell: {json.dumps(pipeline_numbers)}")
    say(f"  variants cells: {json.dumps(variant_numbers)}")
    say(f"  tools cells: {json.dumps(tool_numbers)}")

    by_path = {"serve": serve_launches, "train": launches, "dp": dp_launches,
               "sp-tp": sptp_launches,
               **dpx_launches, **dph_launches,
               "explain": explain_launches, "tgat-train": tgat_launches,
               "tgat-explain": tx_launches, "mixer-train": mixer_launches,
               "mixer-explain": mx_launches, **enhance_launches,
               **cache_launches, **variant_launches, **tool_launches}
    tgat_row = {"sample_rows": "sample_rows tgat hop2 Q=12800",
                "attend": "attend tgat m=12800 dk=258 bfloat16",
                "attend_drop": "attend_drop tgat m=12800 dk=258 bfloat16",
                "attend_bwd": "attend_bwd tgat m=12800 dk=258 bfloat16",
                "walk_to_edge": "walk_to_edge scan path S=8192 T=400"}
    # the enhance TGN's training shapes (batch 100, n 20, d_k 172, bf16):
    # hop level m 2,000 and root m 100, the train form (no explain weight)
    enhance_rows = ("explain hop m=2000 bfloat16",
                    "explain root m=100 bfloat16")
    enhance_of = {"attend_drop": drop_rows, "attend_bwd": bwd_rows}
    # the walk cache build's shapes (batch 128, n 20)
    cache_of = {"sample_rows": CACHE_SHAPES[:2],
                "sample_union": CACHE_SHAPES[2:3],
                "sample_masked": CACHE_SHAPES[3:]}
    kernels = []
    csrc = "tempme_tpu_torch/ops/kernels/csrc/"
    pallas = "tempme_tpu/ops/pallas/"
    for name, src, replaces, rows, err, path in (
            ("sample_rows", csrc + "sample_rows.cu",
             pallas + "sample_kernel.py:126",
             sr_rows["explain hop1 Q=2000"], sr_err, "explain"),
            ("attend", csrc + "attend.cu", pallas + "kernels.py:110",
             at_rows["explain hop m=2000 bfloat16"], at_err, "explain"),
            ("attend_drop", csrc + "attend.cu", pallas + "kernels.py:125",
             drop_rows["hop m=5120 bfloat16"], drop_err, "train"),
            ("attend_bwd", csrc + "attend_bwd.cu",
             pallas + "kernels.py:229,247",
             bwd_rows["explain hop m=2000 bfloat16 ew"], bwd_err, "explain"),
            ("sample_union", csrc + "sample_union.cu",
             pallas + "sample_kernel.py:201", walk_rows["sample_union"],
             walk_errs["sample_union"], "explain"),
            ("sample_masked", csrc + "sample_masked.cu",
             pallas + "sample_kernel.py:267", walk_rows["sample_masked"],
             walk_errs["sample_masked"], "explain"),
            ("walk_to_edge", csrc + "walk_to_edge.cu",
             pallas + "kernels.py:304", walk_rows["walk_to_edge T=400"],
             walk_errs["walk_to_edge"], "explain"),
            ("walk_to_edge_bwd", csrc + "walk_to_edge.cu",
             pallas + "kernels.py:362", walk_rows["walk_to_edge_bwd T=400"],
             walk_errs["walk_to_edge_bwd"], "explain")):
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": by_path[path][name],
                        "launches_by_path": {
                            p: c[name] for p, c in by_path.items()
                            if name in c},
                        "max_abs_err": max(err, tgat_errs.get(name, 0.0)),
                        "ms": rows["ms"],
                        "plain_ms": rows["plain_ms"],
                        "bound_ms": rows["bound_ms"],
                        "bound_by": rows["bound_by"],
                        "library_ms": rows.get("library_ms"),
                        "tgat": dict(tgat_rows[tgat_row[name]],
                                     shape=tgat_row[name])
                        if name in tgat_row else None,
                        "enhance": [dict(enhance_of[name][shape],
                                         shape=shape)
                                    for shape in enhance_rows]
                        if name in enhance_of else None,
                        "cache": [dict(cache_rows[shape], shape=shape)
                                  for shape in cache_of[name]]
                        if name in cache_of else None})
    say(f"[done] chip_smoke.py ran {time.perf_counter() - T0:.1f} s of its "
        f"1,000 s budget, the kernels' build included")
    say(json.dumps({"kernels": kernels}))
    say(gpu_line())
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
