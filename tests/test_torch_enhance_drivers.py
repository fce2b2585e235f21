"""The port's enhance driver end to end on the CPU, on the tiny ``ml_synth``
stream of ``tests/test_torch_drivers.py``, for the three bases:

* ``enhance_main.main(..., device="cpu")`` trains on a TGN, a 2-block
  GraphMixer and (walks alone) a TGAT that ``learn_base`` trained, and
  writes the best checkpoint (both models; the predictor alone for a
  TGAT), the train state (not for a TGAT) and the results JSON, its AP in
  [0, 1]; the saved base differs from the one it loaded;
* a TGN's eval carries the memory through val into test, and the epoch
  then goes on from the memory the train steps left (what the train state
  holds);
* a run of one epoch, resumed to a second with ``--resume``, ends in the
  train state, best checkpoint and results of an uninterrupted 2-epoch
  run, tensor by tensor (``torch.equal``; on the CPU the step is
  deterministic), for a TGN (its memory too) and a GraphMixer;
* ``--freeze_base_epochs`` leaves the base as it was loaded;
* the TGAT branch's ``--resume``, ``--ckpt_every_steps`` and ``main``
  without ``device="cpu"`` where there is no CUDA device raise.
"""
import json
import shutil

import pytest
import torch

from tests.test_torch_drivers import _assert_blobs_equal, _load
from tests.test_torch_drivers import workdir  # noqa: F401 (fixture)
from tests.test_torch_graph_sampler import one_torch_thread  # noqa: F401
from tempme_tpu_torch.train import enhance_main, learn_base

N_DEGREE = 3


def _common(workdir, out, epochs, *extra):  # noqa: F811
    return ["--data", "synth", "--data_dir", str(workdir), "--seed", "0",
            "--bs", "50", "--n_epoch", str(epochs),
            "--log_dir", str(out / "tb"),
            "--results_dir", str(out / "results"), *extra]


@pytest.fixture(scope="module")
def bases(workdir, tmp_path_factory):  # noqa: F811
    """One epoch of a TGN, a 2-block GraphMixer and a 2-layer TGAT."""
    out = tmp_path_factory.mktemp("enhance_bases")
    for base_type, extra in (("tgn", ()), ("graphmixer", ("--n_layer", "2")),
                             ("tgat", ("--n_layer", "2"))):
        learn_base.main(_common(workdir, out, 1, "--base_type", base_type,
                                "--n_degree", str(N_DEGREE), "--out_dir",
                                str(out / "tgnn"), *extra), device="cpu")
    return out


def _enhance(workdir, bases, out, base_type, epochs, *extra):  # noqa: F811
    """``enhance_main`` on ``bases``' checkpoints, writing under ``out``."""
    ckpt = out / "params"
    if not (ckpt / "tgnn").exists():
        shutil.copytree(bases / "tgnn", ckpt / "tgnn")
    return enhance_main.main(
        _common(workdir, out, epochs, "--base_type", base_type,
                "--ckpt_dir", str(ckpt), "--hid_dim", "8", "--out_dim", "8",
                *extra), device="cpu")


@pytest.mark.parametrize("base_type", ["tgn", "graphmixer", "tgat"])
def test_enhance_writes_its_files(workdir, bases, tmp_path,  # noqa: F811
                                  base_type):
    ap = _enhance(workdir, bases, tmp_path, base_type, 1)
    assert 0.0 <= ap <= 1.0
    best = tmp_path / "params" / "enhance" / base_type / "synth.pt"
    meta = json.loads(best.with_name(best.name + ".json").read_text())
    assert (meta["base_type"], meta["out_dim"], meta["hid_dim"],
            meta["n_degree"]) == (base_type, 8, 8, N_DEGREE)
    res = json.loads((tmp_path / "results" /
                      f"enhance_{base_type}_synth.json").read_text())
    assert res["ap"] == ap and res["base_type"] == base_type
    blob = _load(best)
    state = best.with_name(best.name + ".train_state")
    if base_type == "tgat":
        assert set(blob) == {"predictor"} and not state.exists()
        assert "walk_enc_cat.fc1.weight" in blob["predictor"]
        return
    assert set(blob) == {"predictor", "base"}
    assert "aff_fc1.weight" in blob["predictor"]
    assert 0.0 <= res["val_ap"] <= 1.0
    keys = {"predictor", "base", "opt_state", "generator"}
    assert set(_load(state)) == keys | ({"memory"} if base_type == "tgn"
                                        else set())
    loaded = _load(bases / "tgnn" / f"{base_type}_synth.pt")["params"]
    assert loaded.keys() == blob["base"].keys()
    assert any(not torch.equal(loaded[k], blob["base"][k]) for k in loaded)


def test_tgn_eval_carries_the_memory_and_then_restores_it(
        workdir, bases, tmp_path, monkeypatch):  # noqa: F811
    calls = []
    evaluate = enhance_main.evaluate_enhance

    def recording(step, mem, events, bs, seed=enhance_main.EVAL_SEED):
        ap, auc, out = evaluate(step, mem, events, bs, seed)
        calls.append((mem, out))
        return ap, auc, out
    monkeypatch.setattr(enhance_main, "evaluate_enhance", recording)
    _enhance(workdir, bases, tmp_path, "tgn", 1)
    (val_in, val_out), (test_in, test_out) = calls
    for a, b in zip(val_out, test_in):
        assert a is b                     # test starts where val ended
    assert not torch.equal(val_in.memory, test_out.memory)
    saved = _load(tmp_path / "params" / "enhance" / "tgn" /
                  "synth.pt.train_state")["memory"]
    for name, x in val_in._asdict().items():
        assert torch.equal(saved[name], x), name


@pytest.mark.parametrize("base_type", ["tgn", "graphmixer"])
def test_resume_equals_the_uninterrupted_run(workdir, bases, tmp_path,  # noqa: F811
                                             base_type):
    whole, parts = tmp_path / "whole", tmp_path / "parts"
    ap = _enhance(workdir, bases, whole, base_type, 2)
    _enhance(workdir, bases, parts, base_type, 1)
    import contextlib
    import io
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        ap_resumed = _enhance(workdir, bases, parts, base_type, 2,
                              "--resume")
    assert "at epoch 1" in printed.getvalue()
    assert ap_resumed == ap
    best = f"params/enhance/{base_type}/synth.pt"
    for name in (best, best + ".train_state"):
        _assert_blobs_equal(_load(parts / name), _load(whole / name), name)
    for name in (best + ".json", best + ".train_state.json",
                 f"results/enhance_{base_type}_synth.json"):
        assert (parts / name).read_text() == (whole / name).read_text()


def test_freeze_base_epochs_keeps_the_base(workdir, bases,  # noqa: F811
                                           tmp_path):
    _enhance(workdir, bases, tmp_path, "graphmixer", 1,
             "--freeze_base_epochs", "1")
    loaded = _load(bases / "tgnn" / "graphmixer_synth.pt")["params"]
    state = _load(tmp_path / "params" / "enhance" / "graphmixer" /
                  "synth.pt.train_state")
    _assert_blobs_equal(state["base"], loaded, "base")
    loaded_pred = state["predictor"]["aff_fc2.weight"]
    fresh = enhance_main.TempME(8, 4, out_dim=8, hid_dim=8,
                                base_type="graphmixer", device="cpu")
    assert not torch.equal(loaded_pred, fresh.aff_fc2.weight.detach())


def test_refusals(workdir, bases, tmp_path, monkeypatch):  # noqa: F811
    with pytest.raises(ValueError, match="train state"):
        _enhance(workdir, bases, tmp_path, "tgat", 1, "--resume")
    with pytest.raises(ValueError, match="once an epoch"):
        _enhance(workdir, bases, tmp_path, "graphmixer", 1,
                 "--ckpt_every_steps", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        enhance_main.main(_common(workdir, tmp_path, 1, "--base_type",
                                  "graphmixer", "--ckpt_dir",
                                  str(tmp_path / "params")))
