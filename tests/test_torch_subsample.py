"""The port's host-side tools against the JAX package on the CPU:
``data/subsample.py`` bit for bit in both modes, the ``ml_{name}`` files
it writes read back by ``load_dataset``, ``train/sample_tools.py``'s two
commands, the ``supervise`` watchdog under the four cases of
``tests/test_supervise.py``, and ``validate``'s checks on ``ml_synth``
(the kernel check fails without a CUDA device; it is never passed).
"""
import sys

import numpy as np
import pytest
import torch

from tests.conftest import make_events
from tests.test_torch_drivers import workdir  # noqa: F401 (fixture)
from tests.test_torch_graph_sampler import (one_torch_thread,  # noqa: F401
                                            to_torch_events)
from tempme_tpu.data import subsample as JS
from tempme_tpu_torch.data import subsample as S
from tempme_tpu_torch.data.events import load_dataset
from tempme_tpu_torch.tools import validate
from tempme_tpu_torch.tools.supervise import run_supervised
from tempme_tpu_torch.train import sample_tools


@pytest.fixture(scope="module")
def stream():
    ev = make_events(num_events=900, num_nodes=60, seed=4)
    r = np.random.RandomState(1)
    node = r.randn(ev.num_nodes, 5).astype(np.float32)
    edge = r.randn(ev.num_edges, 3).astype(np.float32)
    return ev, node, edge


def _assert_same(port, ref):
    (pe, pn, pf, pm), (je, jn, jf, jm) = port, ref
    for f in ("src", "dst", "ts", "label", "e_idx"):
        a, b = getattr(pe, f), getattr(je, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for a, b in ((pn, jn), (pf, jf), (pm, jm)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [dict(), dict(edge_sample_ratio=0.3,
                                             num_windows=7, min_degree=3,
                                             seed=5)])
def test_temporal_stratified_sample_matches_jax(stream, kw):
    ev, node, edge = stream
    port = S.temporal_stratified_sample(to_torch_events(ev), node, edge, **kw)
    _assert_same(port, JS.temporal_stratified_sample(ev, node, edge, **kw))
    assert 0 < len(port[0]) < len(ev)


@pytest.mark.parametrize("kw", [dict(), dict(node_keep_ratio=0.3,
                                             key_frac=0.5, seed=9)])
def test_session_stratified_sample_matches_jax(stream, kw):
    ev, node, edge = stream
    port = S.session_stratified_sample(to_torch_events(ev), node, edge, **kw)
    _assert_same(port, JS.session_stratified_sample(ev, node, edge, **kw))
    assert 0 < len(port[0]) < len(ev)


def test_analyze_matches_jax(stream):
    ev = stream[0]
    assert S.analyze(to_torch_events(ev)) == JS.analyze(ev)


def test_saved_dataset_loads_back(stream, tmp_path):
    ev, node, edge = stream
    sev, snode, sedge, _ = S.temporal_stratified_sample(to_torch_events(ev),
                                                        node, edge)
    S.save_ml_dataset(str(tmp_path), "cut", sev, snode, sedge)
    ds = load_dataset("cut", str(tmp_path))
    for f in ("src", "dst", "label", "e_idx"):
        np.testing.assert_array_equal(getattr(ds.full, f), getattr(sev, f))
    np.testing.assert_allclose(ds.full.ts, sev.ts, rtol=1e-6)
    np.testing.assert_array_equal(ds.node_feat, snode)
    np.testing.assert_array_equal(ds.edge_feat, sedge)


def test_sample_tools_both_commands(workdir, tmp_path, capsys):  # noqa: F811
    stats = sample_tools.main(["analyze", "--data", "synth", "--data_dir",
                               str(workdir)])
    assert stats["num_events"] == 600 and "max_degree: " in \
        capsys.readouterr().out
    for mode, ratio in (("temporal", "0.5"), ("session", "0.6")):
        out = tmp_path / mode
        after = sample_tools.main(["sample-dataset", "--data", "synth",
                                   "--data_dir", str(workdir), "--mode",
                                   mode, "--ratio", ratio, "--out_dir",
                                   str(out)])
        ds = load_dataset("synth_sampled", str(out))
        assert after["num_events"] == len(ds.full) < 600
        assert after["num_nodes"] == len(np.unique(np.r_[ds.full.src,
                                                         ds.full.dst]))


def test_supervise_clean_exit_passes_through():
    assert run_supervised([sys.executable, "-c", "print('ok')"],
                          stall_timeout=30, max_restarts=1,
                          log=lambda *a: None, _poll_interval=0.1) == 0


def test_supervise_stall_detected_and_resumed(tmp_path):
    marker = tmp_path / "state"
    prog = ("import sys, time, pathlib\n"
            f"m = pathlib.Path({str(marker)!r})\n"
            "if '--resume' in sys.argv and m.exists():\n"
            "    print('resumed ok', flush=True)\n"
            "    sys.exit(0)\n"
            "m.write_text('epoch0')\n"
            "print('epoch 0 done', flush=True)\n"
            "time.sleep(3600)\n")
    assert run_supervised([sys.executable, "-c", prog], stall_timeout=3,
                          max_restarts=2, log=lambda *a: None) == 0
    assert marker.exists()


def test_supervise_exit_during_sleep_is_not_a_stall(tmp_path):
    marker = tmp_path / "ran"
    prog = ("import sys, time, pathlib\n"
            f"m = pathlib.Path({str(marker)!r})\n"
            "m.write_text(m.read_text() + 'x' if m.exists() else 'x')\n"
            "print('starting', flush=True)\n"
            "time.sleep(0.5)\n"
            "sys.exit(0)\n")
    msgs = []
    assert run_supervised([sys.executable, "-c", prog], stall_timeout=1,
                          max_restarts=2, log=msgs.append,
                          _poll_interval=3.0) == 0
    assert marker.read_text() == "x"
    assert not any("STALL" in m for m in msgs)


def test_supervise_gives_up_after_max_restarts():
    assert run_supervised([sys.executable, "-c", "import sys; sys.exit(3)"],
                          stall_timeout=30, max_restarts=1, resume_flag=None,
                          log=lambda *a: None, _poll_interval=0.1) == 3


def test_validate_on_the_cpu(workdir, capsys):  # noqa: F811
    rc = validate.main(["--data", "synth", "--data_dir", str(workdir)],
                       device="cpu")
    out = capsys.readouterr().out
    assert rc == 1 and "4/6 checks passed" in out
    for name in ("imports", "dataset:synth",
                 "explainer train/eval consistency",
                 "walk-importance weights"):
        assert f"PASS  {name}" in out, name
    assert "FAIL  CUDA device" in out
    assert "FAIL  CUDA kernels against their plain versions  no CUDA " \
           "device: the kernels were not checked" in out
    # the kernel check's comparison, run CPU against CPU
    assert validate._kernel_errors(torch.device("cpu")) == {
        "samplers": 0.0, "walk_to_edge": 0.0, "attend": 0.0,
        "attend_drop": 0.0}
