"""Aggregate multi-seed quality runs into mean±std tables.

Port of ``tempme_tpu/tools/aggregate_multiseed.py`` (numpy and json only).
Reads the seed-0 results the port's drivers write (``results_torch/
base_{base}_{data}.json``, ``explainer_{base}_{data}.json``) and the other
seeds' runs under ``results_torch/multiseed/s<seed>/`` (the same file
names; give each seed's run ``--seed <seed> --results_dir
results_torch/multiseed/s<seed>``), and prints markdown rows plus a
machine-readable summary.

    python -m tempme_tpu_torch.tools.aggregate_multiseed \
        [--results_dir results_torch] [--data uslegis_sampled]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import os.path as osp

import numpy as np

BASE_METRICS = ["ap", "auc", "acc", "val_ap"]
EXP_METRICS = ["aps", "auc", "acc", "fid_prob", "fid_logit",
               "r_aps", "r_auc", "r_acc"]


def _load(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def collect(results_dir, data):
    """{(stage, base): {seed: payload}}"""
    out = {}

    def add(stage, base, seed, payload):
        if payload is not None:
            out.setdefault((stage, base), {})[seed] = payload

    for base in ("tgn", "tgat", "graphmixer"):
        add("base", base, 0,
            _load(osp.join(results_dir, f"base_{base}_{data}.json")))
        add("explainer", base, 0,
            _load(osp.join(results_dir, f"explainer_{base}_{data}.json")))
        for sdir in sorted(glob.glob(osp.join(results_dir, "multiseed",
                                              "s*"))):
            try:
                seed = int(osp.basename(sdir)[1:])
            except ValueError:
                continue
            add("base", base, seed,
                _load(osp.join(sdir, f"base_{base}_{data}.json")))
            add("explainer", base, seed,
                _load(osp.join(sdir, f"explainer_{base}_{data}.json")))
    return out


def summarize(runs):
    summary = {}
    for (stage, base), by_seed in sorted(runs.items()):
        metrics = BASE_METRICS if stage == "base" else EXP_METRICS
        row = {"seeds": sorted(by_seed)}
        for m in metrics:
            vals = [p[m] for p in by_seed.values() if m in p]
            if vals:
                row[m] = {"mean": float(np.mean(vals)),
                          "std": float(np.std(vals, ddof=1))
                          if len(vals) > 1 else 0.0,
                          "n": len(vals)}
        summary[f"{stage}_{base}"] = row
    return summary


def markdown(summary):
    lines = []
    base_keys = [k for k in summary if k.startswith("base_")]
    if base_keys:
        lines.append("| Base | seeds | Test AP | Test AUC | Test ACC |")
        lines.append("|---|---|---|---|---|")
        for k in base_keys:
            r = summary[k]
            cells = [k[len("base_"):], str(len(r["seeds"]))]
            for m in ("ap", "auc", "acc"):
                v = r.get(m)
                cells.append(f"{v['mean']:.3f}±{v['std']:.3f}" if v else "—")
            lines.append("| " + " | ".join(cells) + " |")
        lines.append("")
    exp_keys = [k for k in summary if k.startswith("explainer_")]
    if exp_keys:
        lines.append("| Base | seeds | APS | AUC | fid_prob | Ratio-APS "
                     "| Ratio-AUC |")
        lines.append("|---|---|---|---|---|---|---|")
        for k in exp_keys:
            r = summary[k]
            cells = [k[len("explainer_"):], str(len(r["seeds"]))]
            for m in ("aps", "auc", "fid_prob", "r_aps", "r_auc"):
                v = r.get(m)
                cells.append(f"{v['mean']:.3f}±{v['std']:.3f}" if v else "—")
            lines.append("| " + " | ".join(cells) + " |")
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser("tempme_tpu_torch multi-seed aggregator")
    p.add_argument("--results_dir", default="results_torch")
    p.add_argument("--data", default="uslegis_sampled")
    p.add_argument("--out", default="results_torch/multiseed_summary.json")
    args = p.parse_args(argv)
    runs = collect(args.results_dir, args.data)
    summary = summarize(runs)
    print(markdown(summary))
    os.makedirs(osp.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"\nsummary -> {args.out}")
    return summary


if __name__ == "__main__":
    main()
