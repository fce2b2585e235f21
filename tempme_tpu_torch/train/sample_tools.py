"""Dataset subsampling and statistics (the reference's
sampling/sample_dataset.py command line).

    python -m tempme_tpu_torch.train.sample_tools analyze --data enron
    python -m tempme_tpu_torch.train.sample_tools sample-dataset --data enron \
        --ratio 0.15 --out_dir processed

Port of ``tempme_tpu/train/sample_tools.py`` (numpy, host only).
"""
from __future__ import annotations

import argparse
import os

from ..data.events import load_dataset
from ..data.subsample import (analyze, save_ml_dataset,
                              session_stratified_sample,
                              temporal_stratified_sample)


def main(argv=None):
    p = argparse.ArgumentParser("tempme_tpu_torch dataset tools")
    p.add_argument("cmd", choices=["sample-dataset", "analyze"])
    p.add_argument("-d", "--data", type=str, required=True)
    p.add_argument("--data_dir", type=str,
                   default=os.environ.get("TEMPME_DATA_DIR", "processed"))
    p.add_argument("--out_dir", type=str, default="data")
    p.add_argument("--mode", type=str, default="temporal",
                   choices=["temporal", "session"])
    p.add_argument("--ratio", type=float, default=0.15,
                   help="edge ratio (temporal) / node keep ratio (session)")
    p.add_argument("--windows", type=int, default=20)
    p.add_argument("--min_degree", type=int, default=2)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--suffix", type=str, default="sampled")
    args = p.parse_args(argv)

    ds = load_dataset(args.data, args.data_dir)
    if args.cmd == "analyze":
        stats = analyze(ds.full)
        for k, v in stats.items():
            print(f"{k}: {v}")
        return stats

    if args.mode == "temporal":
        ev, nf, ef, _ = temporal_stratified_sample(
            ds.full, ds.node_feat, ds.edge_feat,
            edge_sample_ratio=args.ratio, num_windows=args.windows,
            min_degree=args.min_degree, seed=args.seed)
    else:
        ev, nf, ef, _ = session_stratified_sample(
            ds.full, ds.node_feat, ds.edge_feat,
            node_keep_ratio=args.ratio, seed=args.seed)
    name = f"{args.data}_{args.suffix}"
    save_ml_dataset(args.out_dir, name, ev, nf, ef)
    before, after = analyze(ds.full), analyze(ev)
    print(f"sampled {args.data} -> {name}: "
          f"{before['num_events']} -> {after['num_events']} events, "
          f"{before['num_nodes']} -> {after['num_nodes']} nodes")
    return after


if __name__ == "__main__":
    main()
