"""The port's explainer driver end to end on the CPU, on the tiny ``ml_synth``
stream of ``tests/test_torch_drivers.py``: a TGN trained for one epoch by
``learn_base.main(..., device="cpu")`` is the frozen base, then
``temp_exp_main.main(..., device="cpu")`` trains the explainer. Checked:
the results JSON and checkpoints, the 16-ratio sweep's metrics, a resume
(per epoch and mid-epoch after a simulated kill) that ends in the same
train state, tensor by tensor with ``torch.equal`` (on the CPU the step is
deterministic), ``--eval_only`` reproducing the saved explainer's test
metrics exactly, and ``--profile`` with one epoch tracing nothing.
"""
import json

import pytest
import torch

from tests.test_torch_drivers import _assert_blobs_equal, _load
from tests.test_torch_drivers import workdir  # noqa: F401 (fixture)
from tests.test_torch_graph_sampler import one_torch_thread  # noqa: F401
from tempme_tpu_torch.train import learn_base, temp_exp_main

BS = 20


@pytest.fixture(scope="module")
def base_dir(workdir):  # noqa: F811
    out = workdir / "explainer_ckpts"
    learn_base.main(["--data", "synth", "--data_dir", str(workdir),
                     "--bs", "50", "--seed", "0", "--base_type", "tgn",
                     "--n_degree", "4", "--n_epoch", "1",
                     "--log_dir", str(workdir / "tb"),
                     "--results_dir", str(workdir / "base_results"),
                     "--out_dir", str(out / "tgnn")], device="cpu")
    return out


def _argv(workdir, ckpt_dir, epochs, *extra):
    return ["--data", "synth", "--data_dir", str(workdir), "--bs", str(BS),
            "--test_bs", str(BS), "--seed", "0", "--n_epoch", str(epochs),
            "--log_dir", str(workdir / "tb"),
            "--results_dir", str(ckpt_dir / "results"),
            "--ckpt_dir", str(ckpt_dir), *extra]


def _copy_base(base_dir, tmp):
    """A fresh checkpoint directory holding the base (and the cached null
    distribution), so each run writes its own explainer."""
    (tmp / "tgnn").mkdir(parents=True)
    for f in (base_dir / "tgnn").iterdir():
        (tmp / "tgnn" / f.name).write_bytes(f.read_bytes())
    return tmp


def test_one_epoch_writes_results_and_eval_only_reproduces_them(
        workdir, base_dir, tmp_path):  # noqa: F811
    ck = _copy_base(base_dir, tmp_path / "run")
    best = temp_exp_main.main(_argv(workdir, ck, 1), device="cpu")
    assert 0.0 <= best <= 1.0
    with open(ck / "results" / "explainer_tgn_synth.json") as f:
        res = json.load(f)
    assert res["n_degree"] == 4 and res["val_score"] == best
    for key in ("aps", "auc", "acc", "fid_prob", "fid_logit", "r_aps",
                "r_auc", "r_acc", "r_prob", "r_logit"):
        assert key in res
    assert 0.0 <= res["aps"] <= 1.0 and 0.0 <= res["r_aps"] <= 1.0
    ckpt = ck / "explainer" / "tgn" / "synth.pt"
    assert set(_load(ckpt)) == {"params"}
    assert set(_load(str(ckpt) + ".train_state")) == {
        "params", "opt_state", "generator"}
    assert list(ck.glob("null_synth_n4_s0.npy"))
    ev = temp_exp_main.main(_argv(workdir, ck, 1, "--eval_only"),
                            device="cpu")
    for key, val in ev.items():
        assert val == res[key] or (val != val and res[key] != res[key]), key


def test_resume_continues_bit_for_bit(workdir, base_dir, tmp_path,
                                      monkeypatch):  # noqa: F811
    a = _copy_base(base_dir, tmp_path / "a")
    temp_exp_main.main(_argv(workdir, a, 2), device="cpu")
    b = _copy_base(base_dir, tmp_path / "b")
    temp_exp_main.main(_argv(workdir, b, 1), device="cpu")
    temp_exp_main.main(_argv(workdir, b, 2, "--resume"), device="cpu")
    state = "explainer/tgn/synth.pt.train_state"
    _assert_blobs_equal(_load(a / state), _load(b / state))

    # killed right after the mid-epoch checkpoint of step 4, then resumed
    c = _copy_base(base_dir, tmp_path / "c")
    save = temp_exp_main.save_checkpoint

    class Killed(Exception):
        pass

    def killing_save(path, blob, meta=None):
        save(path, blob, meta=meta)
        if meta and meta.get("step") == 4:
            raise Killed()
    monkeypatch.setattr(temp_exp_main, "save_checkpoint", killing_save)
    with pytest.raises(Killed):
        temp_exp_main.main(_argv(workdir, c, 2, "--ckpt_every_steps", "4"),
                           device="cpu")
    monkeypatch.setattr(temp_exp_main, "save_checkpoint", save)
    temp_exp_main.main(_argv(workdir, c, 2, "--ckpt_every_steps", "4",
                             "--resume"), device="cpu")
    _assert_blobs_equal(_load(a / state), _load(c / state))
    with open(c / (state + ".json")) as f:
        assert json.load(f)["epoch"] == 1


def test_unported_flags_name_their_roadmap_items(workdir, base_dir,
                                                 tmp_path,
                                                 capsys):  # noqa: F811
    """``--profile`` (ported) traces epoch index 1 only: a one-epoch run
    traces nothing and says so."""
    ck = _copy_base(base_dir, tmp_path / "run")
    temp_exp_main.main(_argv(workdir, ck, 1, "--profile", "--bs", "100",
                             "--test_bs", "100"), device="cpu")
    assert "--profile: no epoch traced" in capsys.readouterr().out
    assert not (workdir / "tb" / "trace").exists()
    blob = torch.load(base_dir / "tgnn" / "tgn_synth.pt", weights_only=True)
    assert set(blob) == {"params", "memory"}
