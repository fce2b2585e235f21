"""Environment and model-behaviour checks of the port.

    python -m tempme_tpu_torch.tools.validate --data wikipedia \
        --data_dir processed

Port of ``tempme_tpu/tools/validate.py`` with PyTorch's checks in place of
JAX's: the port's modules import and a CUDA device is present; the
dataset loads with sane shapes; the explainer's train and eval forwards
agree at dropout 0 (and stay close at 0.2) on dummy walks; the walk
importance weights are finite, positive, of mean 1 and not constant; and
each CUDA kernel agrees with its plain version at a toy size on the card
(the samplers bit for bit, ``walk_to_edge`` and ``attend`` with their
backwards within 1e-4). Without a CUDA device the kernel check fails: it
is never passed over. Each check returns ``(name, ok, detail)``; ``main``
prints a table and returns 1 if any failed.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

KERNEL_ATOL = 1e-4        # float32 kernels against float32 plain versions


def check_imports() -> tuple:
    try:
        import tempme_tpu_torch.cli  # noqa: F401
        import tempme_tpu_torch.data.cache  # noqa: F401
        import tempme_tpu_torch.explain.tempme_tgat  # noqa: F401
        import tempme_tpu_torch.models.graphmixer  # noqa: F401
        import tempme_tpu_torch.models.tgat  # noqa: F401
        import tempme_tpu_torch.models.tgn  # noqa: F401
        import tempme_tpu_torch.train.enhance_main  # noqa: F401
        return ("imports", True, f"torch {torch.__version__}, CUDA "
                f"{torch.version.cuda}")
    except Exception as e:  # pragma: no cover
        return ("imports", False, repr(e))


def check_cuda() -> tuple:
    if not torch.cuda.is_available():
        return ("CUDA device", False, "no CUDA device is available")
    return ("CUDA device", True, f"{torch.cuda.get_device_name(0)} x "
            f"{torch.cuda.device_count()}")


def check_dataset(data: str, data_dir: str) -> tuple:
    try:
        from ..data.events import load_dataset
        ds = load_dataset(data, data_dir)
        e, n = ds.full.num_edges, ds.full.num_nodes
        ok = bool(len(ds.full) > 0 and ds.edge_feat.shape[0] >= e
                  and ds.node_feat.shape[0] >= n
                  and np.all(np.diff(ds.full.ts) >= 0))
        return (f"dataset:{data}", ok,
                f"{len(ds.full)} events, {n} nodes, edge_feat "
                f"{ds.edge_feat.shape}, node_feat {ds.node_feat.shape}")
    except Exception as e:
        return (f"dataset:{data}", False, repr(e))


def _dummy_walks(device, b=4, w=12, num_nodes=30, num_edges=50, seed=0):
    from ..explain.tempme import WalkInputs
    from ..ops.sampler import anony_to_cat
    from ..ops.segment import edge_cooccurrence_counts
    r = np.random.RandomState(seed)
    nodes = r.randint(1, num_nodes, (b, w, 6)).astype(np.int32)
    eids = r.randint(1, num_edges, (b, w, 3)).astype(np.int32)
    ts = np.sort(r.rand(b, w, 3).astype(np.float32) * 100.0, axis=-1)[..., ::-1]
    x = r.randint(1, 4, (b, w)).astype(np.int32)
    t = r.randint(0, 4, (b, w)).astype(np.int32)
    eids_t = torch.from_numpy(eids).to(device)
    return WalkInputs(torch.from_numpy(nodes).to(device), eids_t,
                      torch.from_numpy(ts.copy()).to(device),
                      anony_to_cat(torch.from_numpy(x), torch.from_numpy(t))
                      .to(device), edge_cooccurrence_counts(eids_t))


def check_explainer_consistency(device=None) -> tuple:
    """The explainer's training form (dropout draws given) against its eval
    form on dummy walks: equal at dropout 0; at 0.2 the same shapes,
    finite, in [0, 1], mean gap under 0.5."""
    name = "explainer train/eval consistency"
    try:
        from ..explain.tempme import ImpDraws, TempME
        from ..models.common import Features
        from ..utils.devices import resolve_device
        dev = resolve_device(device)
        num_nodes, num_edges, dn, de = 30, 50, 16, 8
        r = np.random.RandomState(0)
        feats = Features(
            torch.from_numpy(r.randn(num_nodes, dn).astype(np.float32)).to(dev),
            torch.from_numpy(r.randn(num_edges, de).astype(np.float32)).to(dev))
        walks = _dummy_walks(dev, num_nodes=num_nodes, num_edges=num_edges)
        cut = torch.full((4,), 120.0, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        gaps = {}
        with torch.no_grad():
            for rate in (0.0, 0.2):
                m = TempME(dn, de, out_dim=16, hid_dim=16, dropout=rate,
                           device=dev, seed=0)
                shapes = m.draw_shapes(4, 12)[0]
                draws = ImpDraws(*(torch.rand(s, generator=gen, device=dev)
                                   for s in shapes))
                imp_eval = m(feats, walks, cut)
                imp_train = m(feats, walks, cut, draws)
                gaps[rate] = float((imp_eval - imp_train).abs().mean())
        ok = (imp_eval.shape == imp_train.shape == (4, 12, 1)
              and bool(torch.isfinite(imp_eval).all())
              and bool(((imp_eval >= 0) & (imp_eval <= 1)).all())
              and gaps[0.0] == 0.0 and gaps[0.2] < 0.5)
        return (name, ok, f"shape {tuple(imp_eval.shape)}, |train-eval| "
                f"mean {gaps[0.0]:.1e} at dropout 0, {gaps[0.2]:.4f} at 0.2")
    except Exception as e:
        return (name, False, repr(e))


def check_walk_importance(device=None) -> tuple:
    """Walk-importance weights: finite, positive, mean 1, not constant."""
    name = "walk-importance weights"
    try:
        from ..explain.tempme import compute_walk_importance
        from ..utils.devices import resolve_device
        dev = resolve_device(device)
        walks = _dummy_walks(dev, seed=1)
        deg = torch.from_numpy((np.random.RandomState(2).rand(30) * 20)
                               .astype(np.float32)).to(dev)
        cut = torch.full((4,), 120.0, device=dev)
        ww = compute_walk_importance(walks.ts, walks.nodes, cut, deg)
        ok = (bool(torch.isfinite(ww).all()) and bool((ww >= 0).all())
              and abs(float(ww.mean()) - 1.0) < 1e-3
              and float(ww.std()) > 1e-4)
        return (name, ok, f"mean {float(ww.mean()):.4f}, std "
                f"{float(ww.std()):.4f}")
    except Exception as e:
        return (name, False, repr(e))


def _kernel_errors(dev) -> dict:
    """Each kernel on ``dev`` against its plain version on the CPU at a toy
    size: the samplers through ``find_k_hop`` and ``find_k_walks`` (ids
    bit for bit: an error of 1 for any difference), ``walk_to_edge`` and
    ``attend``/``attend_drop`` with their backwards. {name: max abs err}."""
    from ..data.events import EventStream
    from ..data.graph import build_temporal_graph
    from ..ops import sampler as S
    from ..ops.kernels.attend import attend, attend_drop
    from ..ops.segment import walk_to_edge_max
    cpu = torch.device("cpu")
    r = np.random.RandomState(0)
    ne, nn_ = 400, 24
    ev = EventStream(r.randint(1, nn_, ne).astype(np.int32),
                     r.randint(1, nn_, ne).astype(np.int32),
                     np.sort(r.randint(0, 200, ne)).astype(np.float32),
                     np.zeros(ne, np.float32),
                     np.arange(1, ne + 1, dtype=np.int32))
    graphs = {d: build_temporal_graph(ev, device=d) for d in (cpu, dev)}
    b, n = 8, 4
    pick = r.randint(0, ne, b)
    src = torch.from_numpy(ev.src[pick])
    eids = torch.from_numpy(ev.e_idx[pick])
    ts = torch.from_numpy(ev.ts[pick])
    gen = torch.Generator().manual_seed(0)
    hops = [torch.rand((b * n ** layer, n), generator=gen) for layer in (0, 1)]
    wd = S.draw_walks(gen, b, n, 3, cpu)
    outs = {}
    for d, g in graphs.items():
        sub = S.find_k_hop(g, [h.to(d) for h in hops], src.to(d), ts.to(d), 2,
                           n, eids=eids.to(d))
        walks = S.find_k_walks(g, S.WalkDraws(*(x.to(d) for x in wd)),
                               src.to(d), sub, n, 3)
        outs[d] = [x.cpu() for x in (*sub.nodes, *sub.eids, *sub.ts, *walks)]
    errs = {"samplers": float(max(not torch.equal(a, c) for a, c in
                                  zip(outs[cpu], outs[dev])))}

    def both(fn, *args):
        """fn's outputs and its inputs' gradients on each device."""
        res = []
        for d in (cpu, dev):
            leaves = [a.detach().to(d).requires_grad_(a.is_floating_point())
                      for a in args]
            out = fn(*leaves)
            out = out if isinstance(out, tuple) else (out,)
            out[0].mul(torch.linspace(-1, 1, out[0].numel(), device=d)
                       .reshape(out[0].shape)).sum().backward()
            res.append([x.detach().cpu() for x in out]
                       + [a.grad.cpu() for a in leaves if a.grad is not None])
        if len(res[0]) != len(res[1]):
            raise AssertionError(f"{len(res[1])} outputs and gradients on "
                                 f"{dev}, {len(res[0])} on the CPU")
        return max(float((a - c).abs().max()) for a, c in zip(*res))

    ids = torch.from_numpy(r.randint(0, 20, (4, 36)).astype(np.int32))
    imp = torch.from_numpy(r.rand(4, 36).astype(np.float32))
    tgt = torch.from_numpy(r.randint(0, 20, (4, 30)).astype(np.int32))
    errs["walk_to_edge"] = both(walk_to_edge_max, ids, imp, tgt)
    m, h, nk, dk = 16, 2, 5, 8
    q = torch.from_numpy(r.randn(m, h, dk).astype(np.float32))
    k = torch.from_numpy(r.randn(m, nk, h, dk).astype(np.float32))
    v = torch.from_numpy(r.randn(m, nk, h, dk).astype(np.float32))
    mask = torch.from_numpy(r.rand(m, nk) < 0.3)
    ew = torch.from_numpy(r.rand(m, nk).astype(np.float32))
    u = torch.from_numpy(r.rand(m, h, nk).astype(np.float32))
    errs["attend"] = both(lambda *a: attend(*a, scale=0.35), q, k, v, mask, ew)
    errs["attend_drop"] = both(
        lambda *a: attend_drop(*a, u.to(a[0].device), 0.1, 0.35),
        q, k, v, mask, ew)
    return errs


def check_kernels(device=None) -> tuple:
    name = "CUDA kernels against their plain versions"
    try:
        if not torch.cuda.is_available():
            return (name, False, "no CUDA device: the kernels were not "
                    "checked")
        dev = torch.device("cuda" if device is None else device)
        if dev.type != "cuda":
            return (name, False, f"device {dev} is not a CUDA device: the "
                    f"kernels were not checked")
        errs = _kernel_errors(dev)
        ok = errs["samplers"] == 0.0 and max(errs.values()) <= KERNEL_ATOL
        return (name, ok, ", ".join(f"{k} max err {v:.1e}"
                                    for k, v in errs.items()))
    except Exception as e:
        return (name, False, repr(e))


def run_all(data: str, data_dir: str, device=None) -> list:
    return [check_imports(), check_cuda(), check_dataset(data, data_dir),
            check_explainer_consistency(device),
            check_walk_importance(device), check_kernels(device)]


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser("validate the setup and the explainer")
    p.add_argument("-d", "--data", type=str, default="uslegis_sampled")
    p.add_argument("--data_dir", type=str,
                   default=os.environ.get("TEMPME_DATA_DIR", "processed"))
    args = p.parse_args(argv)
    results = run_all(args.data, args.data_dir, device)
    width = max(len(n) for n, _, _ in results)
    failed = 0
    for name, ok, detail in results:
        print(f"{'PASS' if ok else 'FAIL'}  {name:<{width}}  {detail}")
        failed += 0 if ok else 1
    print(f"{len(results) - failed}/{len(results)} checks passed")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
