"""Explanation figures.

Port of ``tempme_tpu/tools/visualize.py``:
  * ``visualize_explanations`` -- per-sample edge-importance plots of a
    trained base + explainer pair (one test batch's source side), and the
    batch's motif-class frequencies against the null model, written into
    an output directory;
  * ``plot_improvement_curves`` -- a before/after training-curve
    comparison.

The plots are matplotlib on the host. Where matplotlib is not installed
the same figures are drawn by a small numpy rasteriser into PNGs of the
same names: the points, bars and lines without the axis text, which goes
into the PNG's text chunks (``Title``, ``Description``). The explanation
runs on the
card (``device`` CUDA unless ``"cpu"``), on the explainer driver's paths:
the supports and walks (``sample_rows``, ``sample_union``,
``sample_masked``), the explainer's walk scores and ``edge_importance``
(``walk_to_edge``). ``explain_samples`` computes the plotted arrays from
given draws, so that a test can hold them against the JAX tool's.

    python -m tempme_tpu_torch.cli visualize --data wikipedia \
        --data_dir processed --base_type tgn --ckpt_dir params_torch
"""
from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np
import torch


def _plt():
    """matplotlib's pyplot (Agg), or None where matplotlib is missing."""
    try:
        import matplotlib
    except ModuleNotFoundError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


# ---------------------------------------------------------------------------
# the rasteriser for a host without matplotlib
# ---------------------------------------------------------------------------

_H, _PAD = 360, 24
_BLUE, _ORANGE = (31, 119, 180), (255, 127, 14)


def _write_png(path: str, img: np.ndarray, text: dict) -> str:
    """``img`` [H, W, 3] uint8 as an RGB PNG, ``text`` as tEXt chunks."""
    import struct
    import zlib

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, 3 * w)], axis=1)
    out = b"\x89PNG\r\n\x1a\n" + chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
    for key, value in text.items():
        out += chunk(b"tEXt", key.encode("latin-1") + b"\0"
                     + value.encode("latin-1", "replace"))
    out += chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
    out += chunk(b"IEND", b"")
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(out)
    return path


def _panel(img, x0: int, x1: int):
    """An axes frame over columns [x0, x1); returns its inner box."""
    l, t, r, b = x0 + _PAD, _PAD, x1 - _PAD, _H - _PAD
    img[[t, b], l:r + 1] = 0
    img[t:b + 1, [l, r]] = 0
    return l + 2, t + 2, r - 2, b - 2


def _ramp(v):
    """[0, 1] -> RGB from viridis' dark end to its light end."""
    v = np.clip(np.asarray(v, np.float64), 0.0, 1.0)[..., None]
    return ((1 - v) * np.array([68, 1, 84]) + v * np.array([253, 231, 37])
            ).astype(np.uint8)


def _unit(x):
    x = np.asarray(x, np.float64)
    span = x.max() - x.min() if x.size else 0.0
    return (x - x.min()) / span if span > 0 else np.full(x.shape, 0.5)


def _dots(img, box, x, y, rgb, r=2):
    """Squares of half-width ``r`` at ``x``, ``y`` in [0, 1] of ``box``."""
    l, t, rr, b = box
    px = np.rint(l + np.asarray(x) * (rr - l)).astype(int)
    py = np.rint(b - np.asarray(y) * (b - t)).astype(int)
    for cx, cy, c in zip(px, py, rgb):
        img[max(cy - r, t):min(cy + r, b) + 1,
            max(cx - r, l):min(cx + r, rr) + 1] = c


def _bars(img, box, heights, rgb, slot=0, slots=1, horizontal=False):
    """Bars of ``heights`` in [0, 1], one per row (``horizontal``) or
    column; ``slot`` of ``slots`` side-by-side bars per position."""
    l, t, r, b = box
    n = len(heights)
    length = (r - l) if horizontal else (b - t)
    span = ((b - t) if horizontal else (r - l)) / max(n, 1)
    for i, (v, c) in enumerate(zip(heights, rgb)):
        lo = int(i * span + slot * span / slots + 1)
        hi = int(i * span + (slot + 1) * span / slots - 1)
        k = int(round(float(np.clip(v, 0, 1)) * length))
        if horizontal:
            img[t + lo:t + max(hi, lo + 1), l:l + k] = c
        else:
            img[b - k:b + 1, l + lo:l + max(hi, lo + 1)] = c


# ---------------------------------------------------------------------------
# pure plotting primitives (unit-testable without checkpoints)
# ---------------------------------------------------------------------------

def plot_edge_importance(eids: np.ndarray, imps: np.ndarray, ts: np.ndarray,
                         cut_time: float, path: str, title: str = "") -> str:
    """Scatter of per-edge importance vs event recency for one sample.

    eids/imps/ts are the flattened (hop-0 [+ hop-1]) support arrays; padding
    (eid 0) rows are dropped.
    """
    plt = _plt()
    keep = eids > 0
    eids, imps, ts = eids[keep], imps[keep], ts[keep]
    dt = cut_time - ts
    order = np.argsort(-imps)
    top = order[:min(30, len(order))]
    if plt is None:
        img = np.full((_H, 1100, 3), 255, np.uint8)
        _dots(img, _panel(img, 0, 550), _unit(dt), imps, _ramp(imps))
        _bars(img, _panel(img, 550, 1100), imps[top], [_BLUE] * len(top),
              horizontal=True)
        return _write_png(path, img, {
            "Title": title or "importance vs recency",
            "Description": "left: edge importance (y, 0-1) against the time "
                           f"before prediction (x, {dt.min() if dt.size else 0:g}"
                           f" to {dt.max() if dt.size else 0:g}); right: top "
                           "edges by importance: "
                           + " ".join(f"e{e}" for e in eids[top])})
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    ax1.scatter(dt, imps, s=14, c=imps, cmap="viridis", vmin=0, vmax=1)
    ax1.set_xlabel("Δt before prediction")
    ax1.set_ylabel("edge importance")
    ax1.set_title(title or "importance vs recency")
    ax2.barh(range(len(top)), imps[top], color="tab:blue")
    ax2.set_yticks(range(len(top)))
    ax2.set_yticklabels([f"e{e}" for e in eids[top]], fontsize=6)
    ax2.invert_yaxis()
    ax2.set_xlabel("importance")
    ax2.set_title("top edges")
    fig.tight_layout()
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_motif_distribution(cat_counts: np.ndarray, null_dist: np.ndarray,
                            path: str) -> str:
    """Observed motif-class frequencies vs the null-model prior (12 classes,
    ops/sampler.py CAT_ORDER)."""
    plt = _plt()
    from ..ops.sampler import CAT_ORDER
    obs = cat_counts / max(cat_counts.sum(), 1.0)
    if plt is None:
        img = np.full((_H, 800, 3), 255, np.uint8)
        box = _panel(img, 0, 800)
        top = max(float(np.max(obs)), float(np.max(null_dist)), 1e-12)
        _bars(img, box, obs / top, [_BLUE] * 12, 0, 2)
        _bars(img, box, np.asarray(null_dist) / top, [_ORANGE] * 12, 1, 2)
        return _write_png(path, img, {
            "Title": "motif classes: observed (blue) against the null "
                     "model (orange)",
            "Description": "classes " + " ".join(CAT_ORDER)
                           + f"; bar height 1 = frequency {top:g}"})
    x = np.arange(12)
    fig, ax = plt.subplots(figsize=(8, 3.5))
    ax.bar(x - 0.2, obs, 0.4, label="observed")
    ax.bar(x + 0.2, null_dist, 0.4, label="null model")
    ax.set_xticks(x)
    ax.set_xticklabels(CAT_ORDER, rotation=45, fontsize=7)
    ax.set_ylabel("frequency")
    ax.legend()
    fig.tight_layout()
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_improvement_curves(histories: dict, path: str,
                            metric: str = "aps") -> str:
    """Before/after comparison: ``histories`` maps a label (e.g. "base",
    "enhanced") to a list of per-epoch metric values."""
    plt = _plt()
    if plt is None:
        img = np.full((_H, 600, 3), 255, np.uint8)
        box = _panel(img, 0, 600)
        ys = _unit(np.concatenate([np.asarray(v, np.float64)
                                   for v in histories.values()]))
        k = 0
        for i, vals in enumerate(histories.values()):
            x = np.arange(len(vals)) / max(len(vals) - 1, 1)
            _dots(img, box, x, ys[k:k + len(vals)],
                  [(_BLUE, _ORANGE)[i % 2]] * len(vals), r=3)
            k += len(vals)
        return _write_png(path, img, {
            "Title": f"{metric} over training",
            "Description": "; ".join(f"{label}: " + " ".join(
                f"{v:g}" for v in vals) for label, vals in histories.items())})
    fig, ax = plt.subplots(figsize=(6, 4))
    for label, vals in histories.items():
        ax.plot(range(1, len(vals) + 1), vals, marker="o", label=label)
    ax.set_xlabel("epoch")
    ax.set_ylabel(metric)
    ax.set_title(f"{metric} over training")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


# ---------------------------------------------------------------------------
# checkpoint-driven driver
# ---------------------------------------------------------------------------

@torch.no_grad()
def explain_samples(explainer, feats, g, batch, dst_table, n_degree: int,
                    draws, n_samples: int):
    """The plotted arrays of one batch's source side, from ``draws`` (an
    ``ExplainerDraws`` of the support and the walks): per sample
    ``(eids, imps, ts)`` over its hop-0 then hop-1 support edges (the
    explainer's eval-form ``edge_importance`` of its walk scores, both hops
    for every base as in the JAX tool), and the [12] motif-class counts of
    the batch's source walks. Numpy arrays."""
    from ..explain.tempme_tgat import TempMETGAT
    from ..train.temp_exp_main import sample_explainer_inputs
    _, subs, walks = sample_explainer_inputs(g, batch, dst_table, n_degree,
                                             draws)
    sub, w = subs[0], walks[0]
    if isinstance(explainer, TempMETGAT):
        imp = explainer(feats, w, batch.src, batch.ts, batch.dst)
        imp0, imp1 = explainer.edge_importance(feats, sub, imp, w,
                                               training=False)
    else:
        imp = explainer(feats, w, batch.ts)
        imp0, imp1 = explainer.edge_importance(feats, sub, imp, w,
                                               training=False, hops=(0, 1))
    eids, imps, ts = (np.concatenate([a.cpu().numpy(), b.cpu().numpy()],
                                     axis=1)
                      for a, b in ((sub.eids[0], sub.eids[1]), (imp0, imp1),
                                   (sub.ts[0], sub.ts[1])))
    samples = [(eids[i], imps[i], ts[i])
               for i in range(min(n_samples, eids.shape[0]))]
    cat = w.cat.cpu().numpy().ravel()
    counts = np.bincount(cat, minlength=12)[:12].astype(np.float64)
    return samples, counts


def load_explainer(ckpt_dir: str, base_type: str, data: str, device):
    """The explainer that ``temp_exp_main`` saved at
    ``{ckpt_dir}/explainer/{base_type}/{data}.pt``, in eval form."""
    from ..explain.tempme import TempME
    from ..explain.tempme_tgat import TempMETGAT
    from ..utils.checkpoint import load_checkpoint, load_meta
    path = osp.join(ckpt_dir, "explainer", base_type, f"{data}.pt")
    meta = load_meta(path)
    dims = dict(node_dim=meta["node_dim"], edge_dim=meta["edge_dim"],
                out_dim=meta["out_dim"], hid_dim=meta["hid_dim"],
                dropout=meta["drop_out"], device=device)
    explainer = TempMETGAT(**dims) if base_type == "tgat" else \
        TempME(base_type=base_type, **dims)
    blob, _ = load_checkpoint(path, map_location=device)
    explainer.load_state_dict(blob["params"], strict=True)
    return explainer.eval().requires_grad_(False)


def visualize_explanations(data: str, base_type: str, data_dir: str,
                           ckpt_dir: str, out_dir: str, n_samples: int = 6,
                           seed: int = 0, device=None) -> list:
    """Write ``n_samples`` edge-importance figures and the motif figure of
    one shuffled test batch (at least 2 events) into ``out_dir``; returns
    their paths. The base at ``{ckpt_dir}/tgnn/{base_type}_{data}.pt``
    (loaded strictly, for its ``n_degree``) and the saved explainer run on
    the full stream's graph."""
    from ..config import DEGREE_DICT
    from ..data.events import RandEdgeSampler, load_dataset
    from ..data.graph import build_temporal_graph
    from ..explain.null_model import estimate_null_distribution
    from ..models.common import Features
    from ..ops import sampler as S
    from ..train import loops
    from ..train.base_loader import load_base
    from ..train.temp_exp_main import N_WALK_CONT, ExplainerDraws
    from ..utils.devices import resolve_device

    dev = resolve_device(device)
    ds = load_dataset(data, data_dir)
    g = build_temporal_graph(ds.full, ds.full.num_nodes, ds.full.num_edges,
                             device=dev)
    feats = Features(torch.from_numpy(ds.node_feat).to(dev),
                     torch.from_numpy(ds.edge_feat).to(dev))
    base = load_base(osp.join(ckpt_dir, "tgnn", f"{base_type}_{data}.pt"),
                     device=dev)
    n_degree = int(base.meta.get("n_degree", DEGREE_DICT.get(data, 20)))
    explainer = load_explainer(ckpt_dir, base_type, data, dev)

    sampler = RandEdgeSampler([ds.test.src], [ds.test.dst], seed=seed)
    dst_table = torch.from_numpy(sampler.dst_list).to(dev)
    bs = max(n_samples, 2)
    batch = loops.Batch(*(x[0] for x in loops.stack_batches(
        ds.test, bs, shuffle=True, seed=seed, device=dev)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    draws = ExplainerDraws(
        loops.draw_support(gen, bs, 2, n_degree, dst_table.shape[0], dev),
        tuple(S.draw_walks(gen, bs, n_degree, N_WALK_CONT, dev)
              for _ in range(3)))
    samples, counts = explain_samples(explainer, feats, g, batch, dst_table,
                                      n_degree, draws, n_samples)

    ts, eidx = batch.ts.cpu().numpy(), batch.eidx.cpu().numpy()
    paths = []
    for i, (eids, imps, ets) in enumerate(samples):
        paths.append(plot_edge_importance(
            eids, imps, ets, float(ts[i]),
            osp.join(out_dir, f"{base_type}_{data}_sample{i}.png"),
            title=f"{base_type}/{data} event {int(eidx[i])}"))
    null = estimate_null_distribution(ds.full, n_degree, ds.node_feat,
                                      ds.edge_feat, seed=seed, device=dev)
    paths.append(plot_motif_distribution(
        counts, np.asarray(null),
        osp.join(out_dir, f"{base_type}_{data}_motifs.png")))
    print(f"wrote {len(paths)} figures to {out_dir}")
    return paths


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser("render explanation visualizations")
    p.add_argument("-d", "--data", type=str, default="uslegis_sampled")
    p.add_argument("--base_type", type=str, default="tgn")
    p.add_argument("--data_dir", type=str,
                   default=os.environ.get("TEMPME_DATA_DIR", "processed"))
    p.add_argument("--ckpt_dir", type=str, default="params_torch")
    p.add_argument("--out_dir", type=str,
                   default="explanation_visualizations_torch")
    p.add_argument("--n_samples", type=int, default=6)
    args = p.parse_args(argv)
    visualize_explanations(args.data, args.base_type, args.data_dir,
                           args.ckpt_dir, args.out_dir, args.n_samples,
                           device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
