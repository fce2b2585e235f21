"""The port's drivers with a GraphMixer base, end to end on the CPU, on the
tiny ``ml_synth`` stream of ``tests/test_torch_drivers.py``:

* ``learn_base.main --base_type graphmixer`` trains the default 3 mixer
  blocks over 2-hop supports; its checkpoint meta's ``n_layer`` is the
  block count (the JAX driver writes the support depth, 2, there); the
  checkpoint, train state and results are written, and ``--eval_only``
  reproduces the test metrics it wrote, exactly (the same weights and
  support draws);
* the checkpoint loads whole through ``load_base`` (3 blocks, every
  tensor), and the same blob under a meta that names another block count
  raises instead of dropping or missing a block;
* a run killed right after its first mid-epoch checkpoint and resumed ends
  in the uninterrupted run's train state and best checkpoint, tensor by
  tensor (``torch.equal``; on the CPU the step is deterministic);
* ``temp_exp_main.main --base_type graphmixer`` trains the explainer one
  epoch on that GraphMixer (hop-0 explanations, the sweep's top-k over the
  n hop-0 edges), a run killed at its mid-epoch checkpoint resumes to the
  same train state, and ``--eval_only`` reproduces the saved explainer's
  test metrics exactly.
"""
import json
import shutil

import pytest

from tests.test_torch_drivers import _assert_blobs_equal, _load
from tests.test_torch_drivers import workdir  # noqa: F401 (fixture)
from tests.test_torch_graph_sampler import one_torch_thread  # noqa: F401
from tempme_tpu_torch.train import learn_base, temp_exp_main
from tempme_tpu_torch.train.base_loader import load_base

N_DEGREE = 3


def _argv(workdir, out, *extra):  # noqa: F811
    return ["--data", "synth", "--data_dir", str(workdir), "--seed", "0",
            "--base_type", "graphmixer", "--bs", "50",
            "--log_dir", str(workdir / "tb"),
            "--results_dir", str(out / "results"),
            "--n_degree", str(N_DEGREE), "--n_epoch", "1",
            "--out_dir", str(out / "tgnn"), *extra]


class Killed(Exception):
    pass


def _kill_after_step(module, monkeypatch, step):
    """Make ``module.save_checkpoint`` raise right after it writes the
    mid-epoch checkpoint of ``step``; returns the real one."""
    save = module.save_checkpoint

    def killing_save(path, blob, meta=None):
        save(path, blob, meta=meta)
        if meta and meta.get("step") == step:
            raise Killed()
    monkeypatch.setattr(module, "save_checkpoint", killing_save)
    return save


@pytest.fixture(scope="module")
def mixer_dir(workdir, tmp_path_factory):  # noqa: F811
    """One epoch of a 3-block GraphMixer (checkpoints every 4 steps) and
    its printed log."""
    import contextlib
    import io
    out = tmp_path_factory.mktemp("mixer_base")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        ap = learn_base.main(_argv(workdir, out, "--ckpt_every_steps", "4"),
                             device="cpu")
    return out, ap, printed.getvalue()


def test_graphmixer_trains_and_eval_only_reproduces(workdir,
                                                     mixer_dir):  # noqa: F811
    out, ap, printed = mixer_dir
    assert "model=graphmixer" in printed and "layers=3 bs=50" in printed
    assert 0.0 <= ap <= 1.0
    blob = _load(out / "tgnn" / "graphmixer_synth.pt")
    assert set(blob) == {"params"}
    assert "mixers.2.channel_ffn.fc2.weight" in blob["params"]
    assert not any(k.startswith("time_encoder") for k in blob["params"])
    meta = json.loads((out / "tgnn" / "graphmixer_synth.pt.json")
                      .read_text())
    assert (meta["base_type"], meta["n_layer"], meta["n_degree"]) == (
        "graphmixer", 3, N_DEGREE)
    assert set(_load(out / "tgnn" / "graphmixer_synth.pt.train_state")) == {
        "params", "opt_state", "generator"}
    res = json.loads((out / "results" / "base_graphmixer_synth.json")
                     .read_text())
    assert res["ap"] == ap and {"auc", "acc", "val_ap"} <= set(res)
    test = learn_base.main(_argv(workdir, out, "--eval_only"), device="cpu")
    for key in ("ap", "auc", "acc"):
        assert test[key] == res[key], key


def test_checkpoint_loads_whole_and_a_wrong_block_count_raises(
        mixer_dir, tmp_path):
    path = mixer_dir[0] / "tgnn" / "graphmixer_synth.pt"
    base = load_base(str(path), device="cpu")
    assert len(base.model.mixers) == 3 and not base.model.training
    blob = _load(path)["params"]
    state = base.model.state_dict()
    assert state.keys() == blob.keys()
    for name, x in blob.items():
        assert state[name].equal(x), name
    assert not any(p.requires_grad for p in base.model.parameters())
    for blocks in (2, 4):
        wrong = tmp_path / f"graphmixer_{blocks}.pt"
        shutil.copy(path, wrong)
        meta = json.loads(path.with_name(path.name + ".json").read_text())
        meta["n_layer"] = blocks
        wrong.with_name(wrong.name + ".json").write_text(json.dumps(meta))
        with pytest.raises(RuntimeError, match="mixers"):
            load_base(str(wrong), device="cpu")


def test_graphmixer_mid_epoch_resume_bit_for_bit(workdir, mixer_dir, tmp_path,
                                                 monkeypatch,
                                                 capsys):  # noqa: F811
    """Kill a run right after its checkpoint at step 4, resume it, and end
    where the uninterrupted run of ``mixer_dir`` ends."""
    a, b = mixer_dir[0], tmp_path / "crash"
    save = _kill_after_step(learn_base, monkeypatch, 4)
    with pytest.raises(Killed):
        learn_base.main(_argv(workdir, b, "--ckpt_every_steps", "4"),
                        device="cpu")
    monkeypatch.setattr(learn_base, "save_checkpoint", save)
    capsys.readouterr()
    learn_base.main(_argv(workdir, b, "--ckpt_every_steps", "4",
                          "--resume"), device="cpu")
    assert "at epoch 0 step 4" in capsys.readouterr().out
    for name in ("graphmixer_synth.pt.train_state", "graphmixer_synth.pt"):
        _assert_blobs_equal(_load(a / "tgnn" / name),
                            _load(b / "tgnn" / name), name)


def test_explainer_on_graphmixer_resume_and_eval_only(
        workdir, mixer_dir, tmp_path, monkeypatch):  # noqa: F811
    def copy_base(ck):
        (ck / "tgnn").mkdir(parents=True)
        for f in (mixer_dir[0] / "tgnn").iterdir():
            (ck / "tgnn" / f.name).write_bytes(f.read_bytes())
        return ck

    def argv(ck, *extra):
        return ["--data", "synth", "--data_dir", str(workdir), "--bs", "20",
                "--test_bs", "20", "--seed", "0", "--n_epoch", "1",
                "--base_type", "graphmixer", "--log_dir", str(workdir / "tb"),
                "--results_dir", str(ck / "results"), "--ckpt_dir", str(ck),
                "--ckpt_every_steps", "4", *extra]
    a = copy_base(tmp_path / "a")
    best = temp_exp_main.main(argv(a), device="cpu")
    res = json.loads((a / "results" / "explainer_graphmixer_synth.json")
                     .read_text())
    assert res["n_degree"] == N_DEGREE and res["val_score"] == best
    assert 0.0 <= best <= 1.0
    # a test batch whose base labels are all of one class has no AP or AUC
    # (NaN, as in the JAX package)
    for key in ("aps", "auc", "acc", "r_aps", "r_auc", "r_acc"):
        assert res[key] != res[key] or 0.0 <= res[key] <= 1.0, key
    assert abs(res["fid_prob"]) <= 1.0 and abs(res["r_prob"]) <= 1.0
    blob = _load(a / "explainer" / "graphmixer" / "synth.pt")
    assert "dep_d1.weight" in blob["params"]
    ev = temp_exp_main.main(argv(a, "--eval_only"), device="cpu")
    for key, val in ev.items():
        assert val == res[key] or (val != val and res[key] != res[key]), key

    b = copy_base(tmp_path / "b")
    save = _kill_after_step(temp_exp_main, monkeypatch, 4)
    with pytest.raises(Killed):
        temp_exp_main.main(argv(b), device="cpu")
    monkeypatch.setattr(temp_exp_main, "save_checkpoint", save)
    temp_exp_main.main(argv(b, "--resume"), device="cpu")
    state = "explainer/graphmixer/synth.pt.train_state"
    _assert_blobs_equal(_load(a / state), _load(b / state))
