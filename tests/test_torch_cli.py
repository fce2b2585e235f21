"""The port's command line and pipeline on the CPU, on the ``ml_synth``
layout: ``cli.main`` sends each command to its entry point with its
arguments and the device (``visualize`` and ``profile`` too), runs the
host tools and ``scaling-report``, and refuses ``smoke`` (non-zero,
naming ``chip_smoke.py``) and unknown commands; ``pipeline``
(``batch_train``) runs learn-base ->
explain -> enhance for a GraphMixer, one epoch a stage, in a scratch
working directory with ``TEMPME_DATA_DIR`` set, and a failing stage is
recorded as ``"error"`` and makes the exit code non-zero.
"""
import sys

import pytest

from tests.test_torch_drivers import workdir  # noqa: F401 (fixture)
from tests.test_torch_graph_sampler import one_torch_thread  # noqa: F401
from tempme_tpu_torch import cli
from tempme_tpu_torch.train import batch_train

DRIVERS = {"learn-base": "tempme_tpu_torch.train.learn_base",
           "preprocess": "tempme_tpu_torch.train.preprocess",
           "explain": "tempme_tpu_torch.train.temp_exp_main",
           "enhance": "tempme_tpu_torch.train.enhance_main",
           "pipeline": "tempme_tpu_torch.train.batch_train",
           "validate": "tempme_tpu_torch.tools.validate",
           "visualize": "tempme_tpu_torch.tools.visualize",
           "profile": "tempme_tpu_torch.tools.profile_step"}


@pytest.mark.parametrize("cmd", sorted(DRIVERS))
def test_drivers_get_their_arguments_and_the_device(cmd, monkeypatch):
    module = sys.modules.get(DRIVERS[cmd]) or __import__(
        DRIVERS[cmd], fromlist=["main"])
    seen = []
    monkeypatch.setattr(module, "main",
                        lambda argv, device=None: seen.append((argv, device))
                        or "result")
    assert cli.main([cmd, "--data", "synth"], device="cpu") == "result"
    assert seen == [(["--data", "synth"], "cpu")]


def test_host_tools_run(workdir, tmp_path, capsys):  # noqa: F811
    assert cli.main(["analyze", "--data", "synth", "--data_dir",
                     str(workdir)])["num_events"] == 600
    after = cli.main(["sample-dataset", "--data", "synth", "--data_dir",
                      str(workdir), "--ratio", "0.5", "--out_dir",
                      str(tmp_path)])
    assert 0 < after["num_events"] < 600
    assert (tmp_path / "ml_synth_sampled.csv").exists()
    deg = tmp_path / "deg.npy"
    assert cli.main(["node-degrees", "--data", "synth", "--data_dir",
                     str(workdir), "--out", str(deg)]) == 0 and deg.exists()
    assert cli.main(["supervise", "--stall_timeout", "30", "--",
                     sys.executable, "-c", "print('ok')"]) == 0
    assert cli.exit_code("analyze", {"num_events": 600}) == 0
    assert cli.exit_code("learn-base", 0.87) == 0
    assert cli.exit_code("validate", 1) == 1


@pytest.mark.parametrize("cmd,names", [
    ("smoke", "python3 chip_smoke.py"), ("no-such-command", "unknown")])
def test_unported_commands_exit_non_zero(cmd, names, capsys):
    assert cli.main([cmd, "--data", "synth"], device="cpu") == 1
    assert names in capsys.readouterr().err
    assert cli.main([]) == 1


def test_scaling_report_runs_at_world_sizes_1_and_2(tmp_path, monkeypatch):
    """``cli scaling-report`` (gloo ranks on the CPU) writes only where
    ``--out`` and ``--json_out`` say: the meshes of 1 and 2 ranks, each
    step's collectives a rank by kind the golden's (the TGN's on the sp
    and tp meshes too), the explainer's refused on the sp and tp meshes
    for A16d."""
    import json
    from tempme_tpu_torch.parallel.train import GOLDEN_COLLECTIVES
    monkeypatch.chdir(tmp_path)
    out, js = tmp_path / "out" / "S.md", tmp_path / "out" / "s.json"
    out.parent.mkdir()
    assert cli.main(["scaling-report", "--max_world", "2", "--out",
                     str(out), "--json_out", str(js)]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["out"]
    rows = {r["mesh"]: r for r in json.loads(js.read_text())}
    assert sorted(rows) == ["1x1x1", "1x1x2", "1x2x1", "2x1x1"]
    two = rows["2x1x1"]
    assert two["tgn"]["collectives"] == GOLDEN_COLLECTIVES["tgn"]
    assert two["explainer"]["collectives"] == GOLDEN_COLLECTIVES["explainer"]
    assert rows["1x1x1"]["explainer"]["collectives"]["all_gather"] == 0
    assert two["global_batch"] == 2 * rows["1x1x1"]["global_batch"] == 16
    for mesh, kind in (("1x2x1", "tgn-sp"), ("1x1x2", "tgn-tp")):
        assert rows[mesh]["tgn"]["collectives"] == GOLDEN_COLLECTIVES[kind]
        assert "A16d" in rows[mesh]["explainer"]["refused"]
    assert rows["1x2x1"]["n_degree"] == 2 * rows["1x1x2"]["n_degree"] == 8
    assert "NOT a hardware number" in out.read_text()


@pytest.mark.parametrize("mesh,kind", [((4, 2, 1), "tgn-dp-sp"),
                                       ((2, 2, 2), "tgn-dp-sp-tp")],
                         ids=["4x2x1", "2x2x2"])
def test_scaling_report_measures_the_8_rank_meshes(mesh, kind):
    """The JAX tool's two meshes of 8 ranks (``scaling_report.measure`` at
    the command's defaults: 8 rows a dp index, 4 sp neighbours): the TGN
    step's collectives a rank the golden's, the explainer's refused for
    A16d."""
    from tempme_tpu_torch.parallel.train import GOLDEN_COLLECTIVES
    from tempme_tpu_torch.tools import scaling_report
    row = scaling_report.measure(mesh, 8, 4)
    assert row["tgn"]["collectives"] == GOLDEN_COLLECTIVES[kind]
    assert "A16d" in row["explainer"]["refused"]
    assert (row["global_batch"], row["n_degree"]) == (8 * mesh[0],
                                                      4 * mesh[1])


def test_pipeline_runs_every_stage(workdir, tmp_path,  # noqa: F811
                                   monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TEMPME_DATA_DIR", str(workdir))
    results = cli.main(["pipeline", "--data", "synth", "--base_types",
                        "graphmixer", "--n_epoch_base", "1", "--n_epoch_exp",
                        "1", "--n_epoch_enh", "1"], device="cpu")
    r = results["graphmixer"]
    assert "error" not in r and cli.exit_code("pipeline", results) == 0
    for stage in ("base_ap", "explainer_score", "enhance_ap"):
        assert 0.0 <= r[stage] <= 1.0, stage
    for f in ("params_torch/tgnn/graphmixer_synth.pt",
              "params_torch/explainer/graphmixer/synth.pt",
              "params_torch/enhance/graphmixer/synth.pt",
              "results_torch/enhance_graphmixer_synth.json"):
        assert (tmp_path / f).exists(), f


def test_a_failing_stage_is_recorded_and_fails_the_exit(
        workdir, tmp_path, monkeypatch, capsys):  # noqa: F811
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TEMPME_DATA_DIR", str(workdir))
    seen = []
    real = batch_train.main

    def stage(argv, device=None):
        seen.append(argv[argv.index("--base_type") + 1])
        if seen[-1] == "tgn":
            raise RuntimeError("a stage failed")
        return 0.5
    for name in ("learn_base", "temp_exp_main", "enhance_main"):
        monkeypatch.setattr(f"tempme_tpu_torch.train.{name}.main", stage)
    results = real(["--data", "synth", "--base_types", "tgn,tgat"],
                   device="cpu")
    assert results["tgn"]["error"] is True
    assert "RuntimeError: a stage failed" in capsys.readouterr().err
    # the next base still runs; TGAT's enhance is skipped with its message
    assert results["tgat"]["base_ap"] == results["tgat"]["explainer_score"]
    assert results["tgat"]["enhance_ap"].startswith("skipped")
    assert seen == ["tgn", "tgat", "tgat"]
    assert batch_train.failed(results) and \
        cli.exit_code("pipeline", results) == 1


@pytest.mark.parametrize("name,base", [("wikipedia", "tgat"),
                                       ("mooc", "tgn"), ("synth", "graphmixer")])
def test_config_for_dataset_matches_jax(name, base):
    from tempme_tpu.config import Config as JaxConfig
    from tempme_tpu_torch.config import Config
    port, ref = Config.for_dataset(name, base), JaxConfig.for_dataset(name,
                                                                      base)
    assert port.data.name == ref.data.name
    assert port.sampler == type(port.sampler)(
        **{f: getattr(ref.sampler, f)
           for f in type(port.sampler).__dataclass_fields__})
    for f in ("base_type", "n_degree", "n_layers"):
        assert getattr(port.model, f) == getattr(ref.model, f), f
