"""The port's training driver end to end on the CPU, on a tiny synthetic
dataset in the ``ml_{name}`` layout: one epoch through
``learn_base.main(..., device="cpu")``, a resume that continues bit for bit,
and a mid-epoch ``--ckpt_every_steps`` resume after a simulated kill.
Resumed and uninterrupted train states are compared tensor by tensor with
``torch.equal`` (on the CPU the step is deterministic).
"""
import json

import numpy as np
import pytest
import torch

from conftest import make_events
from tests.test_torch_graph_sampler import one_torch_thread  # noqa: F401
from tempme_tpu_torch.train import learn_base, learn_tgn

N_DEGREE = 5
BS = 50


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """Synthetic dataset in the ml_{name} on-disk layout + scratch dirs."""
    root = tmp_path_factory.mktemp("torch_drivers")
    ev = make_events(num_events=600, num_nodes=30, seed=1)
    lines = ["index,u,i,ts,label,idx"]
    for k in range(len(ev)):
        lines.append(f"{k},{ev.src[k]},{ev.dst[k]},{ev.ts[k]:.1f},"
                     f"{ev.label[k]:.1f},{ev.e_idx[k]}")
    (root / "ml_synth.csv").write_text("\n".join(lines) + "\n")
    r = np.random.RandomState(0)
    np.save(root / "ml_synth.npy", r.randn(len(ev) + 1, 4).astype(np.float32))
    np.save(root / "ml_synth_node.npy", r.randn(30, 8).astype(np.float32))
    return root


def _argv(workdir, out, epochs, *extra):
    return ["--data", "synth", "--data_dir", str(workdir), "--bs", str(BS),
            "--seed", "0", "--log_dir", str(workdir / "tb"),
            "--results_dir", str(workdir / "results"), "--base_type", "tgn",
            "--n_degree", str(N_DEGREE), "--n_epoch", str(epochs),
            "--out_dir", str(out), *extra]


def _assert_blobs_equal(a, b, where="blob"):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_blobs_equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_blobs_equal(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def _load(path):
    return torch.load(path, weights_only=True)


def test_learn_base_tgn_one_epoch(workdir):
    out = workdir / "one_epoch"
    ap = learn_base.main(_argv(workdir, out, 1), device="cpu")
    assert 0.0 <= ap <= 1.0
    ckpt = out / "tgn_synth.pt"
    blob = _load(ckpt)
    assert set(blob) == {"params", "memory"}
    assert set(blob["memory"]) == {"memory", "last_update", "msg_buf",
                                   "msg_ts", "msg_valid"}
    meta = json.loads((out / "tgn_synth.pt.json").read_text())
    assert set(meta) == {
        "base_type", "data", "n_degree", "n_layer", "n_head", "drop_out",
        "node_dim", "edge_dim", "num_nodes", "memory_updater", "aggregator",
        "message_function", "embedding_module", "mean_time_shift",
        "std_time_shift"}
    assert (meta["n_degree"], meta["n_layer"], meta["node_dim"],
            meta["edge_dim"]) == (N_DEGREE, 2, 8, 4)
    state = _load(out / "tgn_synth.pt.train_state")
    assert set(state) == {"params", "opt_state", "generator", "memory"}
    res = json.loads((workdir / "results" / "base_tgn_synth.json")
                     .read_text())
    assert res["base_type"] == "tgn" and res["ap"] == ap
    assert {"ap", "auc", "acc", "val_ap"} <= set(res)


@pytest.mark.parametrize("base, item", [("tgat", "A10")])
def test_unported_bases_name_roadmap_items(workdir, base, item, capsys):
    """Every base and every variant is ported (item A10, the TGAT variants,
    is done: ``tests/test_torch_variant_drivers.py`` trains them); a value
    outside a variant flag's choices is refused by the parser, before any
    work."""
    argv = _argv(workdir, workdir / "unported", 1)
    argv[argv.index("tgn")] = base
    with pytest.raises(SystemExit):
        learn_base.main(argv + ["--agg_method", "max"], device="cpu")
    assert "invalid choice: 'max'" in capsys.readouterr().err
    assert not (workdir / "unported").exists()


def test_resume_bitwise_continuation_tgn(workdir, capsys):
    """3 epochs in one run against 2 epochs, then ``--resume`` to 3."""
    a, b = workdir / "resume_oneshot", workdir / "resume_split"
    learn_base.main(_argv(workdir, a, 3), device="cpu")
    learn_base.main(_argv(workdir, b, 2), device="cpu")
    capsys.readouterr()
    learn_base.main(_argv(workdir, b, 3, "--resume"), device="cpu")
    printed = capsys.readouterr().out
    assert "at epoch 2" in printed and "epoch 0:" not in printed
    for name in ("tgn_synth.pt.train_state", "tgn_synth.pt"):
        _assert_blobs_equal(_load(a / name), _load(b / name), name)
    assert json.loads((a / "tgn_synth.pt.train_state.json").read_text()) \
        == json.loads((b / "tgn_synth.pt.train_state.json").read_text())


def test_step_interval_checkpoint_resume_tgn(workdir, monkeypatch, capsys):
    """Kill a run right after its first mid-epoch checkpoint (every 3
    steps), resume it, and end where an uninterrupted run ends."""
    a, b = workdir / "stepckpt_oneshot", workdir / "stepckpt_crash"
    learn_base.main(_argv(workdir, a, 2, "--ckpt_every_steps", "3"),
                    device="cpu")

    class Killed(Exception):
        pass

    save = learn_tgn.save_checkpoint

    def killing_save(path, blob, meta=None):
        save(path, blob, meta=meta)
        if meta and meta.get("step", -1) >= 0 and meta["epoch"] == 1:
            raise Killed()

    monkeypatch.setattr(learn_tgn, "save_checkpoint", killing_save)
    with pytest.raises(Killed):
        learn_base.main(_argv(workdir, b, 2, "--ckpt_every_steps", "3"),
                        device="cpu")
    monkeypatch.setattr(learn_tgn, "save_checkpoint", save)
    meta = json.loads((b / "tgn_synth.pt.train_state.json").read_text())
    assert (meta["epoch"], meta["step"]) == (1, 3)

    capsys.readouterr()
    learn_base.main(_argv(workdir, b, 2, "--ckpt_every_steps", "3",
                          "--resume"), device="cpu")
    assert "at epoch 1 step 3" in capsys.readouterr().out
    _assert_blobs_equal(_load(a / "tgn_synth.pt.train_state"),
                        _load(b / "tgn_synth.pt.train_state"))
