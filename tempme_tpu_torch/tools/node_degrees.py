"""Per-node degree table of the enhance stage's walk weights.

Port of ``tempme_tpu/tools/node_degrees.py``: each node's count of events,
as source or destination, over the full stream, as a float32
``[num_nodes]`` table with row 0 (the padding id) at 0. The enhance
driver (``train/enhance_main.py``) computes it itself and passes it to
``compute_walk_importance`` as ``node_degree``; this module also saves
and loads it.

    python -m tempme_tpu_torch.tools.node_degrees --data wikipedia \
        --data_dir processed
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..data.events import EventStream, load_dataset


def compute_node_degrees(events: EventStream, num_nodes: int | None = None
                         ) -> np.ndarray:
    n = int(num_nodes if num_nodes is not None else events.num_nodes)
    deg = np.zeros(n, np.float32)
    np.add.at(deg, events.src, 1.0)
    np.add.at(deg, events.dst, 1.0)
    deg[0] = 0.0
    return deg


def save_node_degrees(path: str, deg: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.save(path, deg)


def load_node_degrees(path: str) -> np.ndarray:
    return np.load(path).astype(np.float32)


def main(argv=None) -> int:
    p = argparse.ArgumentParser("per-node degrees of a dataset")
    p.add_argument("-d", "--data", type=str, default="uslegis_sampled")
    p.add_argument("--data_dir", type=str,
                   default=os.environ.get("TEMPME_DATA_DIR", "processed"))
    p.add_argument("--out", type=str, default=None)
    args = p.parse_args(argv)
    ds = load_dataset(args.data, args.data_dir)
    deg = compute_node_degrees(ds.full)
    out = args.out or f"params_torch/node_degrees_{args.data}.npy"
    save_node_degrees(out, deg)
    nz = deg[deg > 0]
    print(f"{args.data}: {len(deg)} nodes, degree mean={nz.mean():.1f} "
          f"median={np.median(nz):.0f} max={nz.max():.0f} -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
