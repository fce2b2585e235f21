"""Configuration for the port's TGN training driver.

The port's copy of the parts of ``tempme_tpu/config.py`` that the TGN path
reads: ``DEGREE_DICT``, the data, model and train configs, the shared
argument groups and ``config_from_args``. The batch size is resolved in one
place, ``resolve_bs``, which ``config_from_args`` calls: an explicit
``--bs`` wins, and a batch size below 1 is refused.
"""
from __future__ import annotations

import dataclasses
import os

# Per-dataset neighbour counts (the reference's learn_base.py:24).
DEGREE_DICT = {
    "wikipedia": 20,
    "reddit": 20,
    "uci": 30,
    "mooc": 60,
    "enron": 30,
    "enron_sampled": 30,
    "canparl": 30,
    "uslegis": 30,
    "uslegis_sampled": 30,
}


@dataclasses.dataclass(frozen=True)
class DataConfig:
    name: str = "uslegis_sampled"
    data_dir: str = ""                    # directory of ml_{name}.csv / .npy


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    base_type: str = "tgn"                # tgn | graphmixer | tgat
    n_degree: int = 30                    # neighbours per hop
    n_layers: int = 2
    n_heads: int = 2
    dropout: float = 0.1
    message_dim: int = 100
    memory_updater: str = "gru"
    aggregator: str = "last"
    message_function: str = "mlp"
    embedding_module: str = "graph_attention"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 256
    lr: float = 1e-3
    n_epoch: int = 20
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class Config:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


def add_common_args(p, bs: int = 256, n_epoch: int = 20, lr: float = 1e-3):
    """Dataset and training flags shared by the drivers."""
    p.add_argument("-d", "--data", type=str, default="uslegis_sampled")
    p.add_argument("--data_dir", type=str,
                   default=os.environ.get("TEMPME_DATA_DIR", "processed"))
    p.add_argument("--bs", type=int, default=None,
                   help=f"batch size (default {bs})")
    p.set_defaults(_bs_nominal=bs)
    p.add_argument("--n_epoch", type=int, default=n_epoch)
    p.add_argument("--lr", type=float, default=lr)
    p.add_argument("--drop_out", type=float, default=0.1)
    p.add_argument("--patience", type=int, default=5,
                   help="early-stop rounds without val-AP improvement")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_dir", type=str, default="tb_logs_torch")
    p.add_argument("--results_dir", type=str, default="results_torch")
    p.add_argument("--ckpt_every_steps", type=int, default=0,
                   help="checkpoint the full train state every N steps so "
                        "--resume restarts mid-epoch (0 = per epoch only)")
    return p


def add_model_args(p):
    """Base-model flags (the reference's learn_base.py:27-40)."""
    p.add_argument("--base_type", type=str, default="tgat")
    p.add_argument("--n_degree", type=int, default=0,
                   help="0 = per-dataset default (DEGREE_DICT)")
    p.add_argument("--n_head", type=int, default=2)
    p.add_argument("--n_layer", type=int, default=3)
    p.add_argument("--memory_updater", choices=["gru", "rnn"], default="gru")
    p.add_argument("--aggregator", choices=["last", "mean"], default="last")
    p.add_argument("--message_function", choices=["mlp", "identity"],
                   default="mlp")
    p.add_argument("--embedding_module",
                   choices=["graph_attention", "identity", "time"],
                   default="graph_attention")
    return p


def resolve_bs(args) -> int:
    """Fill ``args.bs`` from the parser's nominal default when ``--bs`` was
    not given; refuse a batch size below 1."""
    if args.bs is None:
        args.bs = args._bs_nominal
    if args.bs < 1:
        raise ValueError(f"--bs must be at least 1, got {args.bs}")
    return args.bs


def config_from_args(args) -> Config:
    """One Config from parsed args; the driver reads its hyperparameters
    from this tree."""
    data = DataConfig(name=args.data, data_dir=args.data_dir)
    model = ModelConfig(
        base_type=args.base_type,
        n_degree=args.n_degree or DEGREE_DICT.get(data.name, 20),
        n_layers=args.n_layer, n_heads=args.n_head, dropout=args.drop_out,
        memory_updater=args.memory_updater, aggregator=args.aggregator,
        message_function=args.message_function,
        embedding_module=args.embedding_module)
    train = TrainConfig(batch_size=resolve_bs(args), lr=args.lr,
                        n_epoch=args.n_epoch, seed=args.seed)
    return Config(data=data, model=model, train=train)
