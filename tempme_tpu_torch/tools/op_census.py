"""Op census of a ``torch.profiler`` trace: self time by op category.

Port of ``tempme_tpu/tools/op_census.py``. ``parse_trace`` reads the
Chrome traces that ``utils/profiling.py::trace`` writes
(``*.pt.trace.json``) and groups their device events -- kernels
(``"cat": "kernel"``), copies and sets -- into categories by kernel name:
the port's own kernels, GEMMs (cuBLAS, CUTLASS), elementwise, reductions,
index/gather/scatter, copies and sets, other. A trace with no device event
(one taken on the CPU) is grouped by its ``cpu_op`` events instead, each
op's self time being its duration less that of the ops it calls. The
result has the JAX tool's shape: per category the occurrences, the self
time in µs and its share in %, plus the top ops by self time.

    # parse an existing trace
    python -m tempme_tpu_torch.tools.op_census --trace DIR/*.pt.trace.json
    # capture the Enron-shaped TGN train step on the card, then parse
    python -m tempme_tpu_torch.tools.op_census --capture enron --steps 20
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# device kernels: (category, name fragments), first match wins; the names
# are lower-cased ("void attend_kernel<__nv_bfloat16, true, 8>(...)",
# "void at::native::reduce_kernel<...>", "nvjet_tst_..." for cuBLAS)
KERNEL_RULES = (
    ("port kernels", ("attend_kernel", "attend_bwd_kernel",
                      "sample_rows_kernel", "sample_union_kernel",
                      "sample_masked_kernel", "w2e_")),
    ("copy/set", ("memcpy", "memset", "copy", "fill")),
    ("gemm", ("gemm", "cutlass", "xmma", "nvjet", "cublas")),
    ("index/gather/scatter", ("index", "gather", "scatter", "embedding")),
    ("reduction", ("reduce", "softmax", "norm", "scan", "sort")),
    ("elementwise", ("elementwise",)),
)

# CPU ops (a trace with no device event): ``aten::<name>``, trailing
# underscore (in place) dropped
ATEN = {
    "copy/set": {"copy", "to", "_to_copy", "cat", "fill", "zero", "zeros",
                 "clone", "contiguous", "empty", "empty_like", "zeros_like",
                 "ones", "ones_like", "full", "stack"},
    "gemm": {"mm", "addmm", "bmm", "matmul", "linear", "baddbmm"},
    "index/gather/scatter": {"index", "index_select", "index_put",
                             "gather", "scatter", "scatter_add",
                             "scatter_reduce", "embedding", "where",
                             "masked_fill", "take_along_dim", "index_add",
                             "embedding_dense_backward",
                             "embedding_backward"},
    "reduction": {"sum", "mean", "max", "min", "amax", "amin", "argmax",
                  "argmin", "argsort", "sort", "topk", "cumsum", "softmax",
                  "_softmax", "log_softmax", "layer_norm",
                  "native_layer_norm", "all", "any", "prod"},
    "elementwise": {"add", "sub", "mul", "div", "sigmoid", "relu", "tanh",
                    "exp", "log", "pow", "sqrt", "rsqrt", "cos", "sin",
                    "neg", "abs", "clamp", "maximum", "minimum", "eq", "ne",
                    "lt", "le", "gt", "ge", "logical_and", "logical_or",
                    "logical_not", "bitwise_and", "bitwise_or",
                    "bitwise_not", "square", "lerp", "addcmul", "addcdiv",
                    "threshold", "threshold_backward", "sigmoid_backward",
                    "tanh_backward", "rsub", "reciprocal", "floor", "ceil",
                    "sign", "erf", "silu", "gelu"},
}


def category(name: str) -> str:
    """The census category of a kernel or CPU op name."""
    if name.startswith("aten::"):
        op = name[len("aten::"):].rstrip("_")
        if op.startswith("_foreach"):
            return "elementwise"
        for cat, ops in ATEN.items():
            if op in ops:
                return cat
        return "other"
    low = name.lower()
    for cat, frags in KERNEL_RULES:
        if any(f in low for f in frags):
            return cat
    return "other"


def _self_times(events):
    """(name, self µs) of each complete event: its duration less the
    durations of the events nested directly inside it on its thread."""
    by_thread = {}
    for e in events:
        by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    out = []
    for evs in by_thread.values():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0))))
        stack = []                       # [end, name, self] of open events
        for e in evs:
            ts, dur = float(e["ts"]), float(e.get("dur", 0))
            while stack and stack[-1][0] <= ts:
                _, name, own = stack.pop()
                out.append((name, own))
            if stack:
                stack[-1][2] -= dur
            stack.append([ts + dur, e["name"], dur])
        out.extend((name, own) for _, name, own in stack)
    return out


def parse_trace(trace_paths, top_ops=15):
    """Census of the Chrome traces ``trace_paths``: ``(categories,
    top_rows)`` as in the JAX tool. Device events where the traces hold
    any, else ``cpu_op`` events."""
    events = []
    for path in trace_paths:
        with open(path) as f:
            data = json.load(f)
        events += [e for e in data.get("traceEvents", [])
                   if isinstance(e, dict) and e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    if device:
        pairs = [(e["name"], float(e.get("dur", 0))) for e in device]
    else:
        pairs = _self_times([e for e in events if e.get("cat") == "cpu_op"])
    per_op = {}
    for name, us in pairs:
        row = per_op.setdefault(name, [0, 0.0])
        row[0] += 1
        row[1] += us
    cats, rows = {}, []
    for name, (occ, us) in per_op.items():
        cat = category(name)
        agg = cats.setdefault(cat, {"occurrences": 0, "self_time_us": 0.0})
        agg["occurrences"] += occ
        agg["self_time_us"] += us
        rows.append({"op": name, "category": cat, "occurrences": occ,
                     "self_time_us": us})
    rows.sort(key=lambda x: -x["self_time_us"])
    total = sum(a["self_time_us"] for a in cats.values()) or 1.0
    for a in cats.values():
        a["pct"] = 100.0 * a["self_time_us"] / total
    return cats, rows[:top_ops]


def capture_enron_step(steps=20, out_dir="tb_logs_torch/op_census",
                       device=None):
    """Trace ``steps`` TGN train steps on the Enron-shaped stream (the
    whole stream as the train graph, as the JAX tool's setup; batch
    ``TEMPME_BENCH_ENRON_BS``, default 256, 30 neighbours, 2 layers, 2
    heads, dropout 0.1) after three warm-up steps. Returns ``([trace
    path], steps, batch size)``."""
    from ..data.synthetic import make_enron_shaped
    from ..train import loops
    from ..utils import profiling
    from ..utils.devices import resolve_device
    from .profile_step import tgn_train_setup
    dev = resolve_device(device)
    ev, node_feat, edge_feat = make_enron_shaped()
    bs, n_degree = int(os.environ.get("TEMPME_BENCH_ENRON_BS", "256")), 30
    step, mem, gen = tgn_train_setup(ev, node_feat.shape[0],
                                     edge_feat.shape[0], node_feat,
                                     edge_feat, n_degree, dev)
    stacked = loops.stack_batches(ev, bs, shuffle=True, seed=0, device=dev)
    k = min(stacked.src.shape[0], steps + 3)
    batches = [loops.Batch(*(x[i] for x in stacked)) for i in range(k)]
    for b in batches[:3]:             # warm up outside the trace
        mem, aux = step(mem, b, step.draw(gen, bs))
    aux["loss"].item()
    with profiling.trace(out_dir):
        for b in batches[3:]:
            mem, aux = step(mem, b, step.draw(gen, bs))
        aux["loss"].item()
    return [profiling.latest_trace(out_dir)], k - 3, bs


def main(argv=None, device=None):
    """Capture (``--capture enron``, on the CUDA card unless
    ``device="cpu"``) or read (``--trace``) traces, print the census and
    write it as JSON to ``--out``. Returns ``{"meta", "categories",
    "top_ops"}``."""
    p = argparse.ArgumentParser("tempme_tpu_torch op census")
    p.add_argument("--trace", nargs="*", default=None,
                   help="existing *.pt.trace.json path(s) to parse")
    p.add_argument("--capture", choices=["enron"], default=None,
                   help="capture a fresh trace of the named workload first")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--trace_dir", default="tb_logs_torch/op_census",
                   help="where --capture writes its trace")
    p.add_argument("--out", default="results_torch/op_census.json")
    p.add_argument("--top_ops", type=int, default=15)
    args = p.parse_args(argv)

    if args.capture:
        from ..utils.devices import resolve_device
        dev = resolve_device(device)
        paths, steps, bs = capture_enron_step(args.steps, args.trace_dir,
                                              dev)
        meta = {"workload": "enron_shape_tgn_train", "steps": steps,
                "bs": bs, "paths": paths,
                "device": torch.cuda.get_device_name(dev)
                if dev.type == "cuda" else "cpu"}
    elif args.trace:
        paths = args.trace
        meta = {"workload": "existing_trace", "paths": paths}
    else:
        p.error("need --trace or --capture")

    cats, top = parse_trace(paths, args.top_ops)
    order = sorted(cats.items(), key=lambda kv: -kv[1]["self_time_us"])
    print(f"{'category':<28}{'self us':>12}{'%':>8}{'#ops':>8}")
    for cat, a in order:
        print(f"{cat:<28}{a['self_time_us']:>12,.0f}{a['pct']:>8.2f}"
              f"{a['occurrences']:>8}")
    print("\ntop ops by self time:")
    for row in top:
        print(f"  {row['self_time_us']:>10,.0f} us  {row['category']:<22}"
              f"{row['op'][:70]}")
    result = {"meta": meta, "categories": dict(order), "top_ops": top}
    os.makedirs(osp.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"\ncensus -> {args.out}")
    return result


if __name__ == "__main__":
    main()
