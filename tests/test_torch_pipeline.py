"""The offline walk cache end to end on the CPU, on the ``ml_synth``
layout: ``preprocess.main`` against the JAX package's (the same files,
keys, shapes and dtypes; the negatives equal under the same seed), and
``temp_exp_main.main(["--use_cache", ...])`` for a TGN and a GraphMixer
base: one epoch writes the checkpoint and results, a second run reuses
the cache files (their mtimes unchanged), and a run stopped at a
``--ckpt_every_steps`` checkpoint and resumed ends in the uninterrupted
run's train state, tensor by tensor.
"""
import json
import os

import numpy as np
import pytest

from tests.test_torch_drivers import _assert_blobs_equal, _load
from tests.test_torch_drivers import workdir  # noqa: F401 (fixture)
from tests.test_torch_graph_sampler import one_torch_thread  # noqa: F401
from tempme_tpu_torch.data.cache import load_cache
from tempme_tpu_torch.train import learn_base, preprocess, temp_exp_main

N_DEGREE, BS = 4, 20


@pytest.fixture(scope="module")
def bases(workdir):  # noqa: F811
    """A TGN and a 2-block GraphMixer trained one epoch at n_degree 4."""
    out = workdir / "pipeline_ckpts"
    for base in ("tgn", "graphmixer"):
        learn_base.main(["--data", "synth", "--data_dir", str(workdir),
                         "--bs", "50", "--seed", "0", "--base_type", base,
                         "--n_degree", str(N_DEGREE), "--n_layer", "2",
                         "--n_epoch", "1", "--log_dir", str(workdir / "tb"),
                         "--results_dir", str(workdir / "base_results"),
                         "--out_dir", str(out / "tgnn")], device="cpu")
    return out


def _copy_bases(bases, tmp):
    (tmp / "tgnn").mkdir(parents=True)
    for f in (bases / "tgnn").iterdir():
        (tmp / "tgnn" / f.name).write_bytes(f.read_bytes())
    return tmp


def _argv(workdir, ckpt_dir, cache_dir, base, *extra):
    return ["--data", "synth", "--data_dir", str(workdir), "--bs", str(BS),
            "--test_bs", str(BS), "--seed", "0", "--n_epoch", "1",
            "--base_type", base, "--log_dir", str(ckpt_dir / "tb"),
            "--results_dir", str(ckpt_dir / "results"),
            "--ckpt_dir", str(ckpt_dir), "--use_cache", "--cache_dir",
            str(cache_dir), *extra]


def test_preprocess_writes_the_jax_packages_files(workdir, tmp_path):  # noqa: F811,E501
    from tempme_tpu.train import preprocess as jax_preprocess
    argv = ["--data", "synth", "--data_dir", str(workdir), "--n_degree", "3",
            "--bs", "64", "--seed", "7"]
    report = preprocess.main(argv + ["--out_dir", str(tmp_path / "port")],
                             device="cpu")
    jax_preprocess.main(argv + ["--out_dir", str(tmp_path / "jax")])
    for mode in ("train", "test"):
        name = f"synth_{mode}.npz"
        assert report[mode]["path"] == str(tmp_path / "port" / name)
        port = load_cache(str(tmp_path / "port" / name))
        ref = load_cache(str(tmp_path / "jax" / name))
        assert set(port) == set(ref), mode
        for k, v in ref.items():
            assert port[k].dtype == v.dtype and port[k].shape == v.shape, k
        np.testing.assert_array_equal(port["dst_fake"], ref["dst_fake"])
        assert report[mode]["events"] == len(port["dst_fake"])
        for side in ("src", "tgt", "bgd"):
            ids = port[f"subgraph_{side}_1"][:, :2 * 9]
            assert (ids == np.round(ids)).all() and ids.min() >= 0
            cat = port[f"walks_{side}_cat"]
            assert cat.min() >= 0 and cat.max() < 12
        assert abs(port["class_distribution"].sum() - 1.0) < 1e-6


@pytest.mark.parametrize("base", ["tgn", "graphmixer"])
def test_use_cache_trains_reuses_and_resumes(workdir, bases, tmp_path,
                                             monkeypatch, base):  # noqa: F811
    cache = tmp_path / "cache"
    a = _copy_bases(bases, tmp_path / "a")
    best = temp_exp_main.main(_argv(workdir, a, cache, base,
                                    "--ckpt_every_steps", "4"), device="cpu")
    assert 0.0 <= best <= 1.0
    files = sorted(cache.iterdir())
    assert [f.name for f in files] == ["synth_test.npz", "synth_train.npz"]
    mtimes = [os.stat(f).st_mtime_ns for f in files]
    with open(a / "results" / f"explainer_{base}_synth.json") as f:
        res = json.load(f)
    assert res["val_score"] == best and res["n_degree"] == N_DEGREE
    assert 0.0 <= res["aps"] <= 1.0 and 0.0 <= res["r_aps"] <= 1.0
    assert (a / "explainer" / base / "synth.pt").exists()

    # stopped right after the checkpoint of step 4, then resumed
    b = _copy_bases(bases, tmp_path / "b")
    save = temp_exp_main.save_checkpoint

    class Killed(Exception):
        pass

    def killing_save(path, blob, meta=None):
        save(path, blob, meta=meta)
        if meta and meta.get("step") == 4:
            raise Killed()
    monkeypatch.setattr(temp_exp_main, "save_checkpoint", killing_save)
    with pytest.raises(Killed):
        temp_exp_main.main(_argv(workdir, b, cache, base,
                                 "--ckpt_every_steps", "4"), device="cpu")
    monkeypatch.setattr(temp_exp_main, "save_checkpoint", save)
    temp_exp_main.main(_argv(workdir, b, cache, base, "--ckpt_every_steps",
                             "4", "--resume"), device="cpu")
    state = f"explainer/{base}/synth.pt.train_state"
    _assert_blobs_equal(_load(a / state), _load(b / state))
    assert [os.stat(f).st_mtime_ns for f in files] == mtimes
