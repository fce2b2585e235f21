"""The drivers on every base variant, end to end on the CPU, on the tiny
``ml_synth`` stream of ``tests/test_torch_drivers.py``.

The six runs of ``chip_smoke.py``'s [tgn-variants] and [tgat-variants],
at small size: ``learn_base.main(..., device="cpu")`` one epoch each of a
TGN (a) ``--memory_updater rnn --aggregator mean --message_function
identity``, (b) ``--embedding_module identity``, (c) ``--embedding_module
time``, and of a 2-layer TGAT (a) ``--attn_mode map``, (b) ``--agg_method
lstm --use_time pos``, (c) ``--agg_method mean --use_time empty``. Each run
writes its checkpoint with the variant in its meta (a time-embedding TGN
its train split's time statistics), ``load_base`` rebuilds the variant
from it, strictly, and ``--eval_only`` writes the test metrics the run
wrote (a TGAT) or ``evaluate_tgn`` gives from the checkpoint's memory (a
TGN), exactly. The explainer trains one epoch on TGN (a), and refuses
TGN (b) and TGAT (b) with the reason; enhance trains one epoch on TGN
(b).
"""
import json

import numpy as np
import pytest
import torch

from tests.test_torch_drivers import workdir  # noqa: F401 (fixture)
from tests.test_torch_graph_sampler import one_torch_thread  # noqa: F401
from tempme_tpu_torch.data.events import (RandEdgeSampler,
                                          compute_time_statistics,
                                          load_dataset)
from tempme_tpu_torch.data.graph import build_temporal_graph
from tempme_tpu_torch.models.common import Features
from tempme_tpu_torch.train import enhance_main, learn_base, temp_exp_main
from tempme_tpu_torch.train.base_loader import load_base
from tempme_tpu_torch.train.learn_tgn import evaluate_tgn, make_tgn_eval_step

N_DEGREE, BS = 3, 50
RUNS = {
    "tgn_a": ("tgn", ("--memory_updater", "rnn", "--aggregator", "mean",
                      "--message_function", "identity")),
    "tgn_b": ("tgn", ("--embedding_module", "identity")),
    "tgn_c": ("tgn", ("--embedding_module", "time")),
    "tgat_a": ("tgat", ("--attn_mode", "map")),
    "tgat_b": ("tgat", ("--agg_method", "lstm", "--use_time", "pos")),
    "tgat_c": ("tgat", ("--agg_method", "mean", "--use_time", "empty")),
}


def _argv(workdir, out, run, *extra):  # noqa: F811
    base_type, flags = RUNS[run]
    return ["--data", "synth", "--data_dir", str(workdir), "--bs", str(BS),
            "--seed", "0", "--n_epoch", "1", "--n_degree", str(N_DEGREE),
            "--n_layer", "2", "--base_type", base_type,
            "--log_dir", str(out / "tb"), "--results_dir",
            str(out / "results"), "--out_dir", str(out / "tgnn"), *flags,
            *extra]


@pytest.fixture(scope="module")
def runs(workdir, tmp_path_factory):  # noqa: F811
    """Each run's output directory and returned test AP."""
    out = {}
    for run in RUNS:
        d = tmp_path_factory.mktemp(run)
        out[run] = (d, learn_base.main(_argv(workdir, d, run), device="cpu"))
    return out


@pytest.mark.parametrize("run", list(RUNS))
def test_run_checkpoint_reload_and_eval_only(workdir, runs, run):  # noqa: F811,E501
    base_type, flags = RUNS[run]
    d, ap = runs[run]
    assert 0.0 <= ap <= 1.0
    ckpt = d / "tgnn" / f"{base_type}_synth.pt"
    meta = json.loads((d / "tgnn" / f"{base_type}_synth.pt.json")
                      .read_text())
    for flag, value in zip(flags[::2], flags[1::2]):
        assert meta[flag[2:]] == value, flag
    written = json.loads((d / "results" / f"base_{base_type}_synth.json")
                         .read_text())
    assert written["ap"] == ap
    base = load_base(str(ckpt), device="cpu")        # strict
    ds = load_dataset("synth", str(workdir))
    if base_type == "tgat":
        assert meta["pos_seq_len"] == 64
        assert (base.model.agg_method, base.model.attn_mode,
                base.model.use_time) == (meta["agg_method"],
                                         meta["attn_mode"], meta["use_time"])
        want = written
    else:
        stats = compute_time_statistics(ds.train)
        if meta["embedding_module"] == "time":
            assert (tuple(meta["mean_time_shift"]),
                    tuple(meta["std_time_shift"])) == stats
            assert base.model.mean_time_shift == stats[0]
        else:
            assert meta["mean_time_shift"] == [0.0, 0.0]
        dst = RandEdgeSampler([ds.train.src, ds.val.src, ds.test.src],
                              [ds.train.dst, ds.val.dst, ds.test.dst])
        g = build_temporal_graph(ds.full, ds.full.num_nodes,
                                 ds.full.num_edges, device="cpu")
        feats = Features(torch.from_numpy(ds.node_feat),
                         torch.from_numpy(ds.edge_feat))
        step = make_tgn_eval_step(base.model, g, feats,
                                  torch.from_numpy(dst.dst_list), N_DEGREE)
        want, _ = evaluate_tgn(step, base.memory, ds.test, BS)
    test = learn_base.main(_argv(workdir, d, run, "--eval_only"),
                           device="cpu")
    for key in ("ap", "auc", "acc"):
        assert test[key] == want[key], key


def test_identity_embedding_samples_no_support(workdir, runs,  # noqa: F811
                                               monkeypatch):
    """TGN (b)'s steps read no support, so they sample none: the negatives
    and the scores come from the memory alone."""
    from tempme_tpu_torch.train import loops
    d, ap = runs["tgn_b"]
    calls = []
    real = loops.sample_support
    monkeypatch.setattr(loops, "sample_support",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    test = learn_base.main(_argv(workdir, d, "tgn_b", "--eval_only"),
                           device="cpu")
    assert calls == [] and 0.0 <= test["ap"] <= 1.0


def test_explainer_on_tgn_a_and_refusals(workdir, runs):  # noqa: F811
    d, _ = runs["tgn_a"]
    argv = ["--data", "synth", "--data_dir", str(workdir), "--bs", "20",
            "--test_bs", "20", "--seed", "0", "--n_epoch", "1",
            "--log_dir", str(d / "tb_x"), "--results_dir",
            str(d / "results_x"), "--ckpt_dir", str(d)]
    best = temp_exp_main.main(argv + ["--base_type", "tgn"], device="cpu")
    assert 0.0 <= best <= 1.0
    res = json.loads((d / "results_x" / "explainer_tgn_synth.json")
                     .read_text())
    assert np.isfinite(res["r_aps"]) and res["n_degree"] == N_DEGREE
    for run, reason in (("tgn_b", "graph_attention"),
                        ("tgat_b", "--agg_method attn")):
        rd, _ = runs[run]
        with pytest.raises(ValueError, match=reason):
            temp_exp_main.main(argv[:-1] + [str(rd), "--base_type",
                                            RUNS[run][0]], device="cpu")


def test_enhance_on_tgn_b(workdir, runs):  # noqa: F811
    d, _ = runs["tgn_b"]
    ap = enhance_main.main(
        ["--data", "synth", "--data_dir", str(workdir), "--seed", "0",
         "--bs", "50", "--n_epoch", "1", "--log_dir", str(d / "tb_e"),
         "--results_dir", str(d / "results_e"), "--base_type", "tgn",
         "--ckpt_dir", str(d), "--hid_dim", "8", "--out_dim", "8"],
        device="cpu")
    assert 0.0 <= ap <= 1.0
    blob = torch.load(d / "enhance" / "tgn" / "synth.pt", weights_only=True)
    assert not any(k.startswith("attn_layers") for k in blob["base"])
    assert set(blob["base"]) == set(load_base(
        str(d / "tgnn" / "tgn_synth.pt"), device="cpu").model.state_dict())

