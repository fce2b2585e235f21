"""The port's drivers with a TGAT base, end to end on the CPU, on the tiny
``ml_synth`` stream of ``tests/test_torch_drivers.py``:

* ``learn_base.main`` with its default flags trains the 3-layer TGAT at the
  deep-TGAT batch of 32; its checkpoint, train state and results are
  written, and ``--eval_only`` reproduces the test metrics it wrote,
  exactly (the same weights and support draws);
* a run killed right after its first mid-epoch checkpoint and resumed ends
  in the uninterrupted run's train state and best checkpoint, tensor by
  tensor (``torch.equal``; on the CPU the step is deterministic);
* ``--eval_only`` of a TGN scores test from the checkpoint's train-side
  memory, as the JAX package's ``eval_checkpoint`` does: it equals
  ``evaluate_tgn`` from the saved memory on the test split, and differs
  from the test metrics the training run wrote (its memory had run through
  val first);
* ``temp_exp_main.main --base_type tgat`` trains the explainer one epoch on
  that TGAT (3-hop supports, the sweep in chunks of 4 ratios), and its
  ``--eval_only`` reproduces the saved explainer's test metrics exactly.
"""
import json

import pytest

from tests.test_torch_drivers import _assert_blobs_equal, _load
from tests.test_torch_drivers import workdir  # noqa: F401 (fixture)
from tests.test_torch_graph_sampler import one_torch_thread  # noqa: F401
from tempme_tpu_torch.train import learn_base, temp_exp_main

N_DEGREE = 3


def _argv(workdir, out, *extra):  # noqa: F811
    return ["--data", "synth", "--data_dir", str(workdir), "--seed", "0",
            "--log_dir", str(workdir / "tb"),
            "--results_dir", str(out / "results"),
            "--n_degree", str(N_DEGREE), "--n_epoch", "1",
            "--out_dir", str(out / "tgnn"), *extra]


@pytest.fixture(scope="module")
def tgat_dir(workdir, tmp_path_factory):  # noqa: F811
    """One epoch of the default base (TGAT) and its printed log."""
    import contextlib
    import io
    out = tmp_path_factory.mktemp("tgat_base")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        ap = learn_base.main(_argv(workdir, out), device="cpu")
    return out, ap, printed.getvalue()


def test_default_flags_train_tgat_and_eval_only_reproduces(
        workdir, tgat_dir):  # noqa: F811
    out, ap, printed = tgat_dir
    assert "model=tgat" in printed and "layers=3 bs=32" in printed
    assert 0.0 <= ap <= 1.0
    blob = _load(out / "tgnn" / "tgat_synth.pt")
    assert set(blob) == {"params"}
    assert "attn_layers.2.merger.fc22.weight" in blob["params"]
    meta = json.loads((out / "tgnn" / "tgat_synth.pt.json").read_text())
    assert (meta["base_type"], meta["n_layer"], meta["n_degree"],
            meta["agg_method"], meta["attn_mode"], meta["use_time"]) == (
        "tgat", 3, N_DEGREE, "attn", "prod", "time")
    assert set(_load(out / "tgnn" / "tgat_synth.pt.train_state")) == {
        "params", "opt_state", "generator"}
    res = json.loads((out / "results" / "base_tgat_synth.json").read_text())
    assert res["ap"] == ap and {"auc", "acc", "val_ap"} <= set(res)
    test = learn_base.main(_argv(workdir, out, "--eval_only"), device="cpu")
    for key in ("ap", "auc", "acc"):
        assert test[key] == res[key], key


def test_tgat_mid_epoch_resume_bit_for_bit(workdir, tgat_dir, tmp_path,
                                           monkeypatch, capsys):  # noqa: F811
    """Kill a run right after its checkpoint at step 4, resume it, and end
    where an uninterrupted run ends; that run's best checkpoint is the
    fixture's, whose flags differ only by the checkpoint interval."""
    a, b = tmp_path / "oneshot", tmp_path / "crash"
    learn_base.main(_argv(workdir, a, "--ckpt_every_steps", "4"),
                    device="cpu")

    class Killed(Exception):
        pass

    save = learn_base.save_checkpoint

    def killing_save(path, blob, meta=None):
        save(path, blob, meta=meta)
        if meta and meta.get("step", -1) >= 0:
            raise Killed()

    monkeypatch.setattr(learn_base, "save_checkpoint", killing_save)
    with pytest.raises(Killed):
        learn_base.main(_argv(workdir, b, "--ckpt_every_steps", "4"),
                        device="cpu")
    monkeypatch.setattr(learn_base, "save_checkpoint", save)
    capsys.readouterr()
    learn_base.main(_argv(workdir, b, "--ckpt_every_steps", "4",
                          "--resume"), device="cpu")
    assert "at epoch 0 step 4" in capsys.readouterr().out
    for name in ("tgat_synth.pt.train_state", "tgat_synth.pt"):
        _assert_blobs_equal(_load(a / "tgnn" / name),
                            _load(b / "tgnn" / name), name)
    _assert_blobs_equal(_load(a / "tgnn" / "tgat_synth.pt"),
                        _load(tgat_dir[0] / "tgnn" / "tgat_synth.pt"))


def test_tgn_eval_only_reproduces_its_test_metrics(workdir,
                                                   tmp_path):  # noqa: F811
    """The test metrics of the checkpoint's memory, not those after val."""
    import torch
    from tempme_tpu_torch.data.events import RandEdgeSampler, load_dataset
    from tempme_tpu_torch.data.graph import build_temporal_graph
    from tempme_tpu_torch.models.common import Features
    from tempme_tpu_torch.train.base_loader import load_base
    from tempme_tpu_torch.train.learn_tgn import (evaluate_tgn,
                                                  make_tgn_eval_step)
    argv = _argv(workdir, tmp_path, "--base_type", "tgn", "--bs", "50")
    learn_base.main(argv, device="cpu")
    res = json.loads((tmp_path / "results" / "base_tgn_synth.json")
                     .read_text())
    test = learn_base.main(argv + ["--eval_only"], device="cpu")
    ds = load_dataset("synth", str(workdir))
    base = load_base(str(tmp_path / "tgnn" / "tgn_synth.pt"), device="cpu")
    dst = RandEdgeSampler([ds.train.src, ds.val.src, ds.test.src],
                          [ds.train.dst, ds.val.dst, ds.test.dst]).dst_list
    step = make_tgn_eval_step(
        base.model, build_temporal_graph(ds.full, ds.full.num_nodes,
                                         ds.full.num_edges, device="cpu"),
        Features(torch.from_numpy(ds.node_feat),
                 torch.from_numpy(ds.edge_feat)),
        torch.from_numpy(dst), N_DEGREE)
    want, _ = evaluate_tgn(step, base.memory, ds.test, 50)
    for key in ("ap", "auc", "acc"):
        assert test[key] == want[key], key
    assert test["ap"] != res["ap"]


def test_explainer_on_tgat_and_eval_only(workdir, tgat_dir,
                                         tmp_path):  # noqa: F811
    ck = tmp_path
    (ck / "tgnn").mkdir()
    for f in (tgat_dir[0] / "tgnn").iterdir():
        (ck / "tgnn" / f.name).write_bytes(f.read_bytes())
    argv = ["--data", "synth", "--data_dir", str(workdir), "--bs", "20",
            "--test_bs", "20", "--seed", "0", "--n_epoch", "1",
            "--base_type", "tgat", "--log_dir", str(workdir / "tb"),
            "--results_dir", str(ck / "results"), "--ckpt_dir", str(ck)]
    best = temp_exp_main.main(argv, device="cpu")
    res = json.loads((ck / "results" / "explainer_tgat_synth.json")
                     .read_text())
    assert res["n_degree"] == N_DEGREE and res["val_score"] == best
    for key in ("aps", "auc", "acc", "r_aps", "r_auc", "r_acc"):
        assert 0.0 <= res[key] <= 1.0, key
    assert abs(res["fid_prob"]) <= 1.0 and abs(res["r_prob"]) <= 1.0
    blob = _load(ck / "explainer" / "tgat" / "synth.pt")
    assert "event_enc.self_attn.query.weight" in blob["params"]
    ev = temp_exp_main.main(argv + ["--eval_only"], device="cpu")
    for key, val in ev.items():
        assert val == res[key], key
