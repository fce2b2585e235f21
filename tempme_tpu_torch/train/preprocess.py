"""Offline walk/subgraph cache of a dataset's train and test splits.

Usage:
    python -m tempme_tpu_torch.train.preprocess --data wikipedia \
        --data_dir processed --out_dir cache_torch

Port of ``tempme_tpu/train/preprocess.py``: the train split is sampled on
the train graph with the train-only negatives, the test split on the full
graph with the negatives of all three splits, both seeded from ``--seed``,
into ``{out_dir}/{data}_{mode}.npz`` (``data/cache.py``). It runs on the
CUDA device unless a Python caller passes ``device="cpu"`` to ``main``,
and prints each split's build time apart from its ``.npz`` write.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import time

from ..config import DEGREE_DICT
from ..data.cache import build_walk_cache, save_cache
from ..data.events import RandEdgeSampler, load_dataset
from ..data.graph import build_temporal_graph
from ..utils.devices import resolve_device


def main(argv=None, device=None) -> dict:
    """Build and write the caches. Returns per mode the path, the event
    count and the build and write seconds."""
    p = argparse.ArgumentParser("tempme_tpu_torch offline walk cache")
    p.add_argument("-d", "--data", type=str, default="uslegis_sampled")
    p.add_argument("--data_dir", type=str,
                   default=os.environ.get("TEMPME_DATA_DIR", "processed"))
    p.add_argument("--out_dir", type=str, default="cache_torch")
    p.add_argument("--modes", type=str, default="train,test")
    p.add_argument("--n_degree", type=int, default=0,
                   help="0 = per-dataset default (DEGREE_DICT)")
    p.add_argument("--n_walk_cont", type=int, default=3)
    p.add_argument("--bs", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    n_degree = args.n_degree or DEGREE_DICT.get(args.data, 20)
    dev = resolve_device(device)

    ds = load_dataset(args.data, args.data_dir)
    nn_, ne = ds.full.num_nodes, ds.full.num_edges
    os.makedirs(args.out_dir, exist_ok=True)
    report = {}
    for mode in args.modes.split(","):
        if mode == "train":
            g = build_temporal_graph(ds.train, nn_, ne, device=dev)
            events = ds.train
            neg = RandEdgeSampler([ds.train.src], [ds.train.dst],
                                  seed=args.seed)
        elif mode == "test":
            g = build_temporal_graph(ds.full, nn_, ne, device=dev)
            events = ds.test
            neg = RandEdgeSampler(
                [ds.train.src, ds.val.src, ds.test.src],
                [ds.train.dst, ds.val.dst, ds.test.dst], seed=args.seed)
        else:
            raise ValueError(f"unknown mode {mode!r} (train, test)")
        t0 = time.perf_counter()
        cache = build_walk_cache(g, events, neg, n_degree,
                                 n_walk_cont=args.n_walk_cont,
                                 batch_size=args.bs, seed=args.seed)
        build_s = time.perf_counter() - t0    # the outputs are on the host
        out = osp.join(args.out_dir, f"{args.data}_{mode}.npz")
        t0 = time.perf_counter()
        save_cache(out, cache)
        write_s = time.perf_counter() - t0
        n = len(events)
        report[mode] = dict(path=out, events=n, build_s=build_s,
                            write_s=write_s, bytes=osp.getsize(out))
        print(f"{mode}: {n} events -> {out}: built in {build_s:.2f} s "
              f"({n / build_s:,.0f} events/s, n_degree {n_degree}, batch "
              f"{args.bs}, {dev}), written in {write_s:.2f} s "
              f"({osp.getsize(out) / 2 ** 20:,.1f} MiB)")
    return report


if __name__ == "__main__":
    main()
