"""Time this checkout's walk kernels (``sample_rows``, ``sample_union``,
``sample_masked``, ``walk_to_edge`` and its backward) against another build
of them, in turns, on one card.

    python3 -m tempme_tpu_torch.tools.walk_ab OTHER_CSRC [--json PATH]

``OTHER_CSRC`` is a directory with a ``sample_rows.cu``, a
``sample_union.cu`` and a ``sample_masked.cu`` (and the ``csr.cuh`` they
include) and a ``walk_to_edge.cu`` that export the same launchers
(``sample_rows_launch``, ``sample_union_launch``,
``sample_masked_launch``, ``w2e_fwd_launch``, ``w2e_bwd_launch``), for
example an earlier commit's
``tempme_tpu_torch/ops/kernels/csrc`` unpacked with ``git archive``. They
are built and timed by ``tools/ab.py``; this checkout's are built as the
port builds them.

The inputs are the paths' own, captured as ``chip_smoke.py`` captures them
(``capture_walk_inputs``): one train batch of 100 events of the
wikipedia-shaped stream (seed 11), sampled with seeded draws, and the walk
importances of a TempME explainer with seeded weights; and one serving
step's support at batch 256 (``capture_support_rows``). ``sample_rows``
runs at the explainer's hop 0 (Q 100, the time cut of the negative side)
and hop 1 (Q 2,000, edge cut) and at serving's hop 1 (Q 5,120, edge cut);
``sample_union`` at Q 2,000 x 3 draws (one side's walk event 2) and on its
first 129 queries; ``sample_masked`` at Q 6,000 (one side's walk event 3)
and on its first 129 queries; ``walk_to_edge``'s forward and backward at [100, 180] slots
against [100, 20] (hop 0) and [100, 400] (hop 1) targets, the backward
with a seeded cotangent and ``out`` and ``cnt`` from this checkout's
forward. Each build's outputs are first held against the plain PyTorch
version: the samplers bitwise, the forward's ``out`` bitwise and its
``cnt`` exactly (``walk_to_edge_count_plain``), the backward to rtol 1e-5,
atol 1e-5 (each slot sums its share over up to T targets, in another order
than the plain version's). This build's backward is launched twice and
must give the same bits. The largest difference between the two builds'
outputs is printed. Then each is timed six times in turns
(``ab.in_turns``). The launchers are called directly on buffers made
beforehand, so no wrapper or allocation is timed. Prints one line per
kernel and shape and, with ``--json``, writes them all.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import tempfile

import torch

from ..ops.kernels import _build
from ..ops.kernels import sample_masked as SM
from ..ops.kernels import sample_rows as SR
from ..ops.kernels import sample_union as SU
from ..ops.kernels import walk_to_edge as WE
from . import ab

SEED = 0


@contextlib.contextmanager
def recording(module, names):
    """Wrap ``module``'s functions ``names`` to record their arguments in
    the yielded ``{name: [args, ...]}``, and restore them on exit."""
    rec = {name: [] for name in names}
    real = {name: getattr(module, name) for name in names}

    def recorder(name):
        def call(*args):
            rec[name].append(args)
            return real[name](*args)
        return call
    for name in names:
        setattr(module, name, recorder(name))
    try:
        yield rec
    finally:
        for name in names:
            setattr(module, name, real[name])


def capture_walk_inputs(ds, g, dev, batch_size=100, n_degree=20, seed=0):
    """The walk kernels' inputs on the explainer's main path: one train
    batch sampled through ``sample_explainer_inputs``, with
    ``sample_rows``, ``sample_union`` and ``sample_masked`` recorded, and
    the explainer's ``edge_importance`` with ``walk_to_edge_max`` recorded
    (side src: hop 0 and hop 1). ``ds`` is the split stream with its
    features, ``g`` its graph on ``dev``. ``sample_rows`` is recorded in
    the order src, tgt, negative side, hop 0 then hop 1 of each: the
    negative side's hop 0 (the fifth call) is cut by time, the others by
    edge."""
    from ..data.events import RandEdgeSampler
    from ..explain import tempme as E
    from ..models.common import Features
    from ..ops import sampler as S
    from ..train import loops
    from ..train import temp_exp_main as X
    dst = torch.from_numpy(RandEdgeSampler([ds.train.src], [ds.train.dst])
                           .dst_list).to(dev)
    feats = Features(torch.from_numpy(ds.node_feat).to(dev),
                     torch.from_numpy(ds.edge_feat).to(dev))
    batch = loops.Batch(*(x[0] for x in loops.stack_batches(
        ds.train, batch_size, True, seed, dev)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 21)
    draws = X.ExplainerDraws(
        loops.draw_support(gen, batch_size, 2, n_degree, dst.shape[0], dev),
        tuple(S.draw_walks(gen, batch_size, n_degree, X.N_WALK_CONT, dev)
              for _ in range(3)))
    explainer = E.TempME(ds.node_feat.shape[1], ds.edge_feat.shape[1],
                         device=dev, seed=seed)
    with recording(S, ("sample_rows", "sample_union", "sample_masked")) \
            as rec, recording(E, ("walk_to_edge_max",)) as w2e, \
            torch.no_grad():
        _, subs, walks = X.sample_explainer_inputs(g, batch, dst,
                                                   n_degree, draws)
        imp = explainer(feats, walks[0], batch.ts)
        explainer.edge_importance(feats, subs[0], imp, walks[0],
                                  training=False)
    return {**rec, "walk_to_edge": w2e["walk_to_edge_max"]}


def capture_support_rows(ds, g, dev, batch_size=256, n_degree=20, seed=0):
    """``sample_rows``' arguments in one serving step's support: the middle
    batch of 256 of the train split in time order, hop 0 cut by time, hop 1
    by edge, recorded in the order src, dst, negative side, hop 0 then hop
    1 of each."""
    from ..data.events import RandEdgeSampler
    from ..ops import sampler as S
    from ..train import loops
    dst = torch.from_numpy(RandEdgeSampler([ds.train.src], [ds.train.dst])
                           .dst_list).to(dev)
    batches = loops.stack_batches(ds.train, batch_size, False, seed, dev)
    batch = loops.Batch(*(x[x.shape[0] // 2] for x in batches))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 22)
    draws = loops.draw_support(gen, batch_size, 2, n_degree, dst.shape[0],
                               dev)
    with recording(S, ("sample_rows",)) as rec, torch.no_grad():
        loops.sample_support(g, batch, dst, 2, n_degree, draws,
                             use_eidx=False)
    return rec["sample_rows"]


class Case:
    """One kernel call to check and time: ``want()`` gives the outputs to
    hold each build to, ``plain`` is the plain version that is timed,
    ``make()`` allocates one build's outputs and ``launch_args(outs)`` gives
    the launcher's arguments but the stream."""

    def __init__(self, lib, fn, want, plain, make, launch_args):
        self.lib, self.fn = lib, fn
        self.want, self.plain = want, plain
        self.make, self.launch_args = make, launch_args


def rows_case(g, nodes, times, u, eids):
    """One sample_rows call on the captured tensors."""
    q, n = u.shape

    def make():
        return [torch.empty((q, n), dtype=dt, device=g.device)
                for dt in (torch.int32, torch.int32, torch.float32)]

    def launch_args(outs):
        return (g.off.data_ptr(), g.ngh_node.data_ptr(),
                g.ngh_eid.data_ptr(), g.ngh_ts.data_ptr(),
                g.edge_ts.data_ptr(), nodes.data_ptr(),
                None if times is None else times.data_ptr(),
                None if eids is None else eids.data_ptr(), u.data_ptr(),
                q, n, g.num_nodes, g.num_edges,
                *(o.data_ptr() for o in outs))

    def plain():
        return SR.sample_rows_plain(g, nodes, times, u, eids)
    return Case("sample_rows", "sample_rows_launch", plain, plain, make,
                launch_args)


def union_case(g, args):
    """One sample_union call on the captured tensors ``args`` (node_a,
    node_b, eid_cut, u)."""
    q, n = args[-1].shape

    def make():
        return [torch.empty((q, n), dtype=dt, device=g.device)
                for dt in (torch.int32, torch.int32, torch.int32,
                           torch.float32)]

    def launch_args(outs):
        return (g.off.data_ptr(), g.ngh_node.data_ptr(),
                g.ngh_eid.data_ptr(), g.ngh_ts.data_ptr(),
                g.edge_ts.data_ptr(), *(t.data_ptr() for t in args), q, n,
                g.num_nodes, g.num_edges, *(o.data_ptr() for o in outs))

    def plain():
        return SU.sample_union_plain(g, *args)
    return Case("sample_union", "sample_union_launch", plain, plain, make,
                launch_args)


def masked_case(g, args):
    """One sample_masked call on the captured tensors ``args``."""
    q = args[-1].shape[0]

    def make():
        return [torch.empty((q,), dtype=dt, device=g.device)
                for dt in (torch.int32, torch.int32, torch.int32,
                           torch.float32, torch.bool)]

    def launch_args(outs):
        return (g.off.data_ptr(), g.ngh_node.data_ptr(),
                g.ngh_eid.data_ptr(), g.ngh_ts.data_ptr(),
                g.bynb_ngh.data_ptr(), g.bynb_eid.data_ptr(),
                g.bynb_ts.data_ptr(), g.edge_ts.data_ptr(),
                *(t.data_ptr() for t in args), q, g.num_nodes, g.num_edges,
                *(o.data_ptr() for o in outs))

    def plain():
        return SM.sample_masked_plain(g, *args)
    return Case("sample_masked", "sample_masked_launch", plain, plain, make,
                launch_args)


def fwd_case(ids, imp, tgt):
    """One walk_to_edge forward call: ``out`` and ``cnt``."""
    b, s = ids.shape
    t = tgt.shape[1]

    def make():
        return [torch.empty((b, t), dtype=torch.float32, device=ids.device),
                torch.empty((b, t), dtype=torch.int32, device=ids.device)]

    def launch_args(outs):
        return (ids.data_ptr(), imp.data_ptr(), tgt.data_ptr(), b, s, t,
                outs[0].data_ptr(), outs[1].data_ptr())
    return Case("walk_to_edge", "w2e_fwd_launch",
                lambda: (WE.walk_to_edge_plain(ids, imp, tgt),
                         WE.walk_to_edge_count_plain(ids, imp, tgt)),
                lambda: WE.walk_to_edge_plain(ids, imp, tgt), make,
                launch_args)


def bwd_case(ids, imp, tgt, ct):
    """One walk_to_edge backward call, ``out`` and ``cnt`` from this
    checkout's forward."""
    out, cnt = WE.walk_to_edge_fwd(ids, imp, tgt)
    b, s = ids.shape

    def plain():
        with torch.enable_grad():
            leaf = imp.detach().requires_grad_()
            return torch.autograd.grad(WE.walk_to_edge_plain(ids, leaf, tgt),
                                       [leaf], ct)

    def launch_args(outs):
        return (ids.data_ptr(), imp.data_ptr(), tgt.data_ptr(),
                out.data_ptr(), cnt.data_ptr(), ct.data_ptr(), b, s,
                tgt.shape[1], outs[0].data_ptr())
    return Case("walk_to_edge", "w2e_bwd_launch", plain, plain,
                lambda: [torch.empty_like(imp)], launch_args)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_csrc")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("walk_ab: no CUDA device", file=sys.stderr)
        return 1
    from ..data.events import split_events
    from ..data.graph import build_temporal_graph
    from ..data.synthetic import make_large_shaped
    dev = torch.device("cuda")
    card = ab.card_line()
    print(f"[walk_ab] {card}; other sources {args.other_csrc}", flush=True)
    ev, node_feat, edge_feat = make_large_shaped("wikipedia")
    ds = split_events(ev, node_feat=node_feat, edge_feat=edge_feat)
    g = build_temporal_graph(ds.full, ds.full.num_nodes, ds.full.num_edges,
                             device=dev)
    rec = capture_walk_inputs(ds, g, dev, seed=SEED)
    serve_rows = capture_support_rows(ds, g, dev, seed=SEED)
    union = rec["sample_union"][0][1:]
    masked = rec["sample_masked"][0][1:]
    explain_rows = rec["sample_rows"]
    cases = [("sample_rows", "Q=100", rows_case(*explain_rows[4])),
             ("sample_rows", "Q=2000", rows_case(*explain_rows[1])),
             ("sample_rows", "Q=5120", rows_case(*serve_rows[1])),
             ("sample_union", "Q=2000", union_case(g, union)),
             ("sample_union", "Q=129",
              union_case(g, [t[:129].contiguous() for t in union])),
             ("sample_masked", "Q=6000", masked_case(g, masked)),
             ("sample_masked", "Q=129",
              masked_case(g, [t[:129].contiguous() for t in masked]))]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 23)
    for ids, imp, tgt in rec["walk_to_edge"][:2]:
        ids, tgt = ids.to(torch.int32), tgt.to(torch.int32)
        ct = torch.randn(tgt.shape, generator=gen, device=dev)
        t = f"T={tgt.shape[1]}"
        cases += [("walk_to_edge", t, fwd_case(ids, imp, tgt)),
                  ("walk_to_edge_bwd", t, bwd_case(ids, imp, tgt, ct))]
    this = {"sample_rows": SR._lib(), "sample_union": SU._lib(),
            "sample_masked": SM._lib(), "walk_to_edge": WE._lib()}
    rows = []
    with tempfile.TemporaryDirectory(prefix="walk_ab_") as tmp:
        other = ab.build_other(args.other_csrc, tuple(this), tmp)
        other = {"sample_rows": SR._typed(other["sample_rows"]),
                 "sample_union": SU._typed(other["sample_union"]),
                 "sample_masked": SM._typed(other["sample_masked"]),
                 "walk_to_edge": WE._typed(other["walk_to_edge"])}
        for name, shape, case in cases:
            lib_of = {"this": this, "other": other}
            outs = {b: case.make() for b in lib_of}

            def run(build, case=case, outs=outs):
                stream = torch.cuda.current_stream().cuda_stream
                err = getattr(lib_of[build][case.lib], case.fn)(
                    *case.launch_args(outs[build]), stream)
                _build.check(err, f"{build} {case.fn}")

            want = case.want()
            for build in lib_of:
                run(build)
                torch.cuda.synchronize()
                for a, b in zip(outs[build], want):
                    if name == "walk_to_edge_bwd":
                        torch.testing.assert_close(a, b, rtol=1e-5,
                                                   atol=1e-5)
                    elif not torch.equal(a, b):
                        raise AssertionError(
                            f"{build} {name} {shape} differs from its "
                            f"plain version")
            if name == "walk_to_edge_bwd":
                first = outs["this"][0].clone()
                run("this")
                torch.cuda.synchronize()
                if not torch.equal(first, outs["this"][0]):
                    raise AssertionError(f"{name} {shape}: two launches "
                                         "gave different bits")
            diff = max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(outs["this"], outs["other"]))
            times = ab.in_turns({"plain": case.plain,
                                 "other": lambda: run("other"),
                                 "this": lambda: run("this")})
            row = dict(kernel=name, shape=shape, this_vs_other=diff,
                       **{f"{b}_ms": t for b, t in times.items()})
            rows.append(row)
            print(f"  {name:16s} {shape:7s} {ab.turns_text(times)}; "
                  f"|this - other| {diff:.2e}", flush=True)
    print(card)
    if args.json:
        ab.write_json(args.json, card, rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
