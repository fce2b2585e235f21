"""The port's debug mode (``tempme_tpu_torch/utils/debug.py``) on the CPU:
``check_finite`` names the offending tensor by its path and passes a sound
tree, as ``tests/test_debug.py`` holds the JAX module; a training driver
run with ``TEMPME_DEBUG=1`` at the smallest driver-test size prints the
mode line, ends normally and leaves autograd's anomaly mode as it was; and
a NaN planted in a parameter after the epoch's last step raises
``FloatingPointError`` at the epoch-end check, naming it.
"""
import numpy as np
import pytest
import torch

from tests.test_torch_drivers import _argv
from tests.test_torch_drivers import workdir  # noqa: F401 (fixture)
from tests.test_torch_graph_sampler import one_torch_thread  # noqa: F401
from tempme_tpu_torch.data.events import load_dataset
from tempme_tpu_torch.train import learn_base, learn_tgn
from tempme_tpu_torch.utils import debug

BS = 100


def test_check_finite_names_offending_tensor():
    good = {"a": torch.ones(4), "b": {"c": torch.zeros(2, 2)},
            "flags": torch.tensor([True, False])}
    debug.check_finite(good, "good tree")          # no raise
    bad = {"a": torch.ones(4),
           "b": {"c": torch.tensor([1.0, np.nan, 2.0, np.inf])}}
    with pytest.raises(FloatingPointError, match=r"at b\.c: 2/4 bad"):
        debug.check_finite(bad, "bad tree")
    m = torch.nn.Sequential(torch.nn.Linear(3, 2))
    debug.check_finite(m, "module")
    with torch.no_grad():
        m[0].bias[1] = np.inf
    with pytest.raises(FloatingPointError, match=r"at 0\.bias: 1/2 bad"):
        debug.check_finite(m, "module")


@pytest.fixture
def debug_env(monkeypatch):
    monkeypatch.setenv("TEMPME_DEBUG", "1")
    before = (torch.is_anomaly_enabled(),
              torch.is_anomaly_check_nan_enabled())
    yield
    assert (torch.is_anomaly_enabled(),
            torch.is_anomaly_check_nan_enabled()) == before
    torch.autograd.set_detect_anomaly(*before)


@pytest.mark.parametrize("plant", [False, True])
def test_driver_debug_mode(workdir, tmp_path, debug_env, monkeypatch,
                           capsys, plant):  # noqa: F811
    """One TGN epoch under ``TEMPME_DEBUG=1``: sound, it ends with an AP;
    with a NaN planted in a parameter after the last train step, the
    epoch-end check names that parameter."""
    name = "memory_updater.weight_hh"
    if plant:
        ds = load_dataset("synth", str(workdir))
        last = len(ds.train) // BS
        step = learn_tgn.TGNTrainStep.__call__
        calls = []

        def planting(self, mem, batch, draws):
            out = step(self, mem, batch, draws)
            calls.append(1)
            if len(calls) == last:
                with torch.no_grad():
                    dict(self.model.named_parameters())[name][0, 0] = np.nan
            return out
        monkeypatch.setattr(learn_tgn.TGNTrainStep, "__call__", planting)
        with pytest.raises(FloatingPointError,
                           match=rf"params after epoch at {name}: 1/"):
            learn_base.main(_argv(workdir, tmp_path, 1, "--bs", str(BS)),
                            device="cpu")
    else:
        ap = learn_base.main(_argv(workdir, tmp_path, 1, "--bs", str(BS)),
                             device="cpu")
        assert 0.0 <= ap <= 1.0
    assert "[debug] TEMPME_DEBUG=1: autograd anomaly detection" in \
        capsys.readouterr().out
