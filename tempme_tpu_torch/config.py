"""Configuration for the port's drivers (base training, the explainer).

The port's copy of ``tempme_tpu/config.py``: ``DEGREE_DICT``,
``DEFAULT_RATIOS``, the data, model, sampler, explainer, train and parallel
configs (``ParallelConfig``: the mesh axes; only ``dp`` above 1 runs,
``parallel/mesh.py``), ``Config.for_dataset``,
the shared argument groups and ``config_from_args``. The
batch size is resolved in one place, ``resolve_bs``, which
``config_from_args`` calls: an explicit ``--bs`` wins, a batch size below 1
is refused, and a driver that trains a 3-layer TGAT resolves it first with
the deep-TGAT batch of 32 (``learn_base.main``). ``n_layers`` is per base:
the TGN runs 2 layers whatever ``--n_layer`` says, TGAT ``--n_layer``
(3 by default), GraphMixer ``--n_layer`` mixer blocks (3 by default) over
2-hop supports of which it reads hop 0.
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

# The explainer's fidelity sweep: the shares of support edges kept
# (the reference's temp_exp_main.py:699).
DEFAULT_RATIOS = (0.01, 0.02, 0.04, 0.06, 0.08, 0.10, 0.12, 0.14,
                  0.16, 0.18, 0.20, 0.22, 0.24, 0.26, 0.28, 0.30)


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
    token_expansion: float = 0.5          # GraphMixer's token FFN width / n
    channel_expansion: float = 4.0        # and channel FFN width / channels
    message_dim: int = 100
    memory_updater: str = "gru"
    aggregator: str = "last"
    message_function: str = "mlp"
    embedding_module: str = "graph_attention"
    agg_method: str = "attn"              # TGAT: attn | lstm | mean
    attn_mode: str = "prod"               # TGAT: prod | map
    use_time: str = "time"                # TGAT: time | pos | empty


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Temporal neighbour and motif walk sampling."""
    n_degree: int = 30
    bias: float = 0.0                     # exp-decay bias (0: uniform)
    n_walks_deg: int = 30                 # first-hop fanout of the walks
    walk_neighbors: int = 3               # continuations per first event
    chunk: int = 128                      # candidate-scan chunk


@dataclasses.dataclass(frozen=True)
class ExplainerConfig:
    """The TempME explainer (the reference's temp_exp_main.py:30-53)."""
    out_dim: int = 40
    hid_dim: int = 64
    prior_p: float = 0.3
    beta: float = 0.5
    dropout: float = 0.1
    ratios: tuple = DEFAULT_RATIOS


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 256
    lr: float = 1e-3
    weight_decay: float = 0.0
    n_epoch: int = 20
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """The mesh axes (``parallel/mesh.py``): ``dp`` data parallel over the
    batch; ``sp`` the support's columns and the TGN memory's rows; ``tp``
    the Dense kernels' output rows (with their Adam moments). The TGN step
    runs all three; the explainer's and enhance's steps run dp alone
    (ROADMAP A16d)."""
    dp: int = 1
    sp: int = 1
    tp: int = 1

    @property
    def n_devices(self) -> int:
        return self.dp * self.sp * self.tp


@dataclasses.dataclass(frozen=True)
class Config:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    sampler: SamplerConfig = dataclasses.field(default_factory=SamplerConfig)
    explainer: ExplainerConfig = dataclasses.field(
        default_factory=ExplainerConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    parallel: ParallelConfig = dataclasses.field(
        default_factory=ParallelConfig)

    @staticmethod
    def for_dataset(name: str, base_type: str = "tgn",
                    **overrides) -> "Config":
        """The defaults for dataset ``name``: its neighbour count, and 3
        layers for a TGAT, else 2; ``overrides`` replace whole groups."""
        deg = DEGREE_DICT.get(name, 20)
        cfg = Config(
            data=DataConfig(name=name),
            model=ModelConfig(base_type=base_type, n_degree=deg,
                              n_layers=3 if base_type == "tgat" else 2),
            sampler=SamplerConfig(n_degree=deg, n_walks_deg=deg))
        return dataclasses.replace(cfg, **overrides) if overrides else cfg


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
    p.add_argument("--agg_method", choices=["attn", "lstm", "mean"],
                   default="attn")
    p.add_argument("--attn_mode", choices=["prod", "map"], default="prod")
    p.add_argument("--use_time", choices=["time", "pos", "empty"],
                   default="time")
    return p


def add_explainer_args(p):
    """Explainer flags (the reference's temp_exp_main.py:30-53)."""
    p.add_argument("--out_dim", type=int, default=40)
    p.add_argument("--hid_dim", type=int, default=64)
    p.add_argument("--prior_p", type=float, default=0.3)
    p.add_argument("--beta", type=float, default=0.5)
    p.add_argument("--weight_decay", type=float, default=0.0)
    return p


def resolve_bs(args, deep_tgat_bs: int = 0) -> int:
    """Fill ``args.bs`` from the parser's nominal default when ``--bs`` was
    not given; refuse a batch size below 1. A driver that trains the full
    deep TGAT pyramid passes ``deep_tgat_bs`` (32 in the published runs):
    a TGAT of 3 or more layers then takes the smaller of it and the nominal
    default. An explicit ``--bs`` always wins."""
    if args.bs is None:
        deep = (deep_tgat_bs and getattr(args, "base_type", "") == "tgat"
                and getattr(args, "n_layer", 2) >= 3)
        args.bs = min(args._bs_nominal, deep_tgat_bs) if deep \
            else args._bs_nominal
    if args.bs < 1:
        raise ValueError(f"--bs must be at least 1, got {args.bs}")
    return args.bs


def config_from_args(args) -> Config:
    """One Config from parsed args; the drivers read their hyperparameters
    from this tree. Groups a driver did not add keep their defaults."""
    def g(name, default):
        return getattr(args, name, default)
    data = DataConfig(name=args.data, data_dir=args.data_dir)
    model = ModelConfig(
        base_type=args.base_type,
        n_degree=g("n_degree", 0) or DEGREE_DICT.get(data.name, 20),
        n_layers=g("n_layer", 2), n_heads=g("n_head", 2),
        dropout=args.drop_out,
        memory_updater=g("memory_updater", "gru"),
        aggregator=g("aggregator", "last"),
        message_function=g("message_function", "mlp"),
        embedding_module=g("embedding_module", "graph_attention"),
        agg_method=g("agg_method", "attn"), attn_mode=g("attn_mode", "prod"),
        use_time=g("use_time", "time"))
    sampler = SamplerConfig(n_degree=model.n_degree,
                            n_walks_deg=model.n_degree)
    explainer = ExplainerConfig(
        out_dim=g("out_dim", 40), hid_dim=g("hid_dim", 64),
        prior_p=g("prior_p", 0.3), beta=g("beta", 0.5),
        dropout=args.drop_out)
    train = TrainConfig(batch_size=resolve_bs(args), lr=args.lr,
                        weight_decay=g("weight_decay", 0.0),
                        n_epoch=args.n_epoch, seed=args.seed)
    return Config(data=data, model=model, sampler=sampler,
                  explainer=explainer, train=train)
