"""The port's profiling tools on the CPU: ``utils/profiling.py::trace``
writes a Chrome trace that parses; ``tools/profile_step.py`` on the tiny
``ml_synth`` stream prints every key of the JAX tool's line, each stage
finite and above 0; ``tools/op_census.py::parse_trace`` gives shares that
sum to 100 on a CPU capture (its ``cpu_op`` events, self times) and on a
hand-written device trace, whose kernels it sorts into the right
categories; and ``temp_exp_main --profile`` traces epoch index 1 of a
two-epoch run, which the census reads.
"""
import json
import math

import pytest
import torch

from tests.test_torch_drivers import workdir  # noqa: F401 (fixture)
from tests.test_torch_graph_sampler import one_torch_thread  # noqa: F401
from tests.test_torch_visualize import write_tgn_base
from tempme_tpu_torch.data.events import load_dataset
from tempme_tpu_torch.tools import op_census, profile_step
from tempme_tpu_torch.train import temp_exp_main
from tempme_tpu_torch.utils import profiling

JAX_KEYS = ("sample_ms", "fwd_ms", "fwd_drop_ms", "embed_ms", "memory_ms",
            "fwdbwd_ms", "full_ms", "events_per_s_full", "sample_hop0_ms",
            "sample_hop1_ms")


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as d:
        with profiling.annotate("region"):
            x = torch.randn(32, 32)
            (x @ x).sum()
    with open(profiling.latest_trace(d)) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events if e.get("ph") == "X"}
    assert {"region", "aten::mm"} <= names
    with pytest.raises(FileNotFoundError):
        profiling.latest_trace(str(tmp_path / "none"))


@pytest.fixture(scope="module")
def step_profile(workdir, tmp_path_factory):  # noqa: F811
    out = tmp_path_factory.mktemp("profile_step") / "trace"
    return profile_step.main(["--data", "synth", "--data_dir", str(workdir),
                              "--bs", "20", "--n_degree", "4", "--trace",
                              str(out)], device="cpu")


def test_profile_step_prints_every_stage(step_profile, capsys):
    for key in JAX_KEYS:
        v = step_profile[key]
        assert math.isfinite(v) and v > 0, key
    assert (step_profile["bs"], step_profile["n_degree"],
            step_profile["backend"]) == (20, 4, "cpu")
    assert set(step_profile["clock"].values()) == {"host"}
    assert set(step_profile["launches"]) == {
        k[:-len("_ms")] for k in JAX_KEYS if k.endswith("_ms")}
    assert step_profile["trace"].endswith(".pt.trace.json")


def _close_to_100(cats):
    return abs(sum(a["pct"] for a in cats.values()) - 100.0) <= 0.1


def test_census_of_a_cpu_capture(step_profile, tmp_path):
    cats, top = op_census.parse_trace([step_profile["trace"]], top_ops=5)
    assert _close_to_100(cats)
    assert len(top) == 5 and top[0]["self_time_us"] >= top[-1]["self_time_us"]
    assert cats["gemm"]["occurrences"] > 0
    assert all(a["self_time_us"] >= 0 for a in cats.values())
    out = tmp_path / "census.json"
    res = op_census.main(["--trace", step_profile["trace"], "--out",
                          str(out)])
    assert json.loads(out.read_text())["categories"] == \
        json.loads(json.dumps(res["categories"]))


KERNELS = {
    "void attend_kernel<__nv_bfloat16, true, 8>(__nv_bfloat16 const*)":
        ("port kernels", 30.0),
    "void attend_bwd_kernel<__nv_bfloat16, 8>(__nv_bfloat16 const*)":
        ("port kernels", 50.0),
    "sample_rows_kernel(int const*, int const*, float const*)":
        ("port kernels", 5.0),
    "w2e_fwd_kernel(int const*, float const*, int)": ("port kernels", 2.5),
    "nvjet_tst_128x64_64x8_1x2_h_bz_TNN": ("gemm", 40.0),
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n": ("gemm", 20.0),
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
    "at::native::func_wrapper_t<float, at::native::sum_functor<float> > "
    "> >(at::native::ReduceOp<float>)": ("reduction", 12.0),
    "void at::native::vectorized_elementwise_kernel<4, "
    "at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> >(int)":
        ("elementwise", 8.0),
    "void at::native::indexSelectLargeIndex<float, long, unsigned int>()":
        ("index/gather/scatter", 6.0),
    "void at::native::elementwise_kernel<128, 2, "
    "at::native::direct_copy_kernel_cuda>()": ("copy/set", 4.0),
    "Memcpy HtoD (Pageable -> Device)": ("copy/set", 10.0),
    "Memset (Device)": ("copy/set", 1.5),
    "my_unknown_kernel": ("other", 11.0),
}


def test_census_of_a_device_trace(tmp_path):
    events, t = [], 0.0
    for name, (_, dur) in KERNELS.items():
        cat = "gpu_memcpy" if name.startswith("Memcpy") else \
            "gpu_memset" if name.startswith("Memset") else "kernel"
        for _ in range(2):
            events.append({"ph": "X", "cat": cat, "name": name, "pid": 0,
                           "tid": 7, "ts": t, "dur": dur})
            t += 100.0
    # host events of a device trace are left out of its census
    events += [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1,
                "tid": 1, "ts": 0.0, "dur": 500.0},
               {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "pid": 1, "tid": 1, "ts": 1.0, "dur": 3.0},
               {"ph": "i", "cat": "kernel", "name": "marker", "ts": 5.0}]
    path = tmp_path / "dev.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    cats, top = op_census.parse_trace([str(path)], top_ops=3)
    assert _close_to_100(cats)
    want = {}
    for name, (cat, dur) in KERNELS.items():
        assert op_census.category(name) == cat, name
        agg = want.setdefault(cat, [0, 0.0])
        agg[0] += 2
        agg[1] += 2 * dur
    assert {c: [a["occurrences"], a["self_time_us"]]
            for c, a in cats.items()} == want
    assert cats["port kernels"]["pct"] == pytest.approx(
        100 * 175.0 / sum(a[1] for a in want.values()))
    assert [r["op"].split("<")[0] for r in top] == [
        "void attend_bwd_kernel", "nvjet_tst_128x64_64x8_1x2_h_bz_TNN",
        "void attend_kernel"]


def test_census_of_nested_cpu_ops(tmp_path):
    """A ``cpu_op``'s self time is its duration less its children's."""
    ev = [("aten::linear", 0.0, 100.0), ("aten::t", 1.0, 4.0),
          ("aten::addmm", 10.0, 80.0), ("aten::copy_", 20.0, 30.0),
          ("aten::add", 200.0, 10.0)]
    events = [{"ph": "X", "cat": "cpu_op", "name": n, "pid": 1, "tid": 1,
               "ts": ts, "dur": d} for n, ts, d in ev]
    path = tmp_path / "cpu.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    cats, top = op_census.parse_trace([str(path)])
    self_us = {r["op"]: r["self_time_us"] for r in top}
    assert self_us == {"aten::linear": 16.0, "aten::t": 4.0,
                       "aten::addmm": 50.0, "aten::copy_": 30.0,
                       "aten::add": 10.0}
    assert cats["gemm"]["self_time_us"] == 66.0
    assert cats["other"]["self_time_us"] == 4.0
    assert _close_to_100(cats)


def test_explainer_profile_traces_epoch_one(workdir, tmp_path,  # noqa: F811
                                            capsys):
    ck = tmp_path / "params"
    write_tgn_base(ck, load_dataset("synth", str(workdir)), 4)
    temp_exp_main.main(["--data", "synth", "--data_dir", str(workdir),
                        "--bs", "100", "--test_bs", "100", "--n_epoch", "2",
                        "--log_dir", str(tmp_path / "tb"), "--results_dir",
                        str(tmp_path / "results"), "--ckpt_dir", str(ck),
                        "--profile"], device="cpu")
    printed = capsys.readouterr().out
    path = profiling.latest_trace(str(tmp_path / "tb" / "trace"))
    assert f"profiler trace -> {path}" in printed
    assert "no epoch traced" not in printed
    cats, _ = op_census.parse_trace([path])
    assert _close_to_100(cats) and cats["gemm"]["occurrences"] > 0
