"""Profiling hooks: ``torch.profiler`` traces, named regions, a throughput
counter and the card's timers.

Port of ``tempme_tpu/utils/profiling.py``. ``trace`` writes a Chrome trace
(``*.pt.trace.json``, which ``tools/op_census.py`` reads and
``chrome://tracing`` or Perfetto shows) where ``jax.profiler`` wrote an
xplane. The timers below read the CUDA card: ``time_ms`` (CUDA graph
replay and CUDA events), ``eager_ms`` (CUDA events around eager calls, for
work that a graph cannot hold), ``busy_ms`` (the device-busy time of
such work, from ``torch.profiler``) and ``profile_steps`` (the device's
busy share of a traced window); ``host_ms`` is the host clock, for the
CPU.
``chip_smoke.py`` and the tools share them.
"""
from __future__ import annotations

import contextlib
import glob
import os
import os.path as osp
import time
from typing import Dict

import torch


def _activities():
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str = "tb_logs_torch/trace"):
    """Capture a ``torch.profiler`` trace of the block (CPU ops and, with a
    CUDA card, its kernels, copies and sets) and write it as a Chrome trace
    ``<host>_<pid>.<ms>.pt.trace.json`` under ``log_dir``. Yields
    ``log_dir``; ``latest_trace(log_dir)`` is the file written."""
    from torch.profiler import profile, tensorboard_trace_handler
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities(),
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def latest_trace(log_dir: str) -> str:
    """The newest ``*.pt.trace.json`` under ``log_dir``."""
    paths = sorted(glob.glob(osp.join(log_dir, "**", "*.pt.trace.json"),
                             recursive=True), key=osp.getmtime)
    if not paths:
        raise FileNotFoundError(f"no trace written under {log_dir}")
    return paths[-1]


@contextlib.contextmanager
def annotate(name: str):
    """Named region visible in profiler traces."""
    with torch.profiler.record_function(name):
        yield


class Throughput:
    """events/s (and arbitrary unit/s) counter with EMA smoothing."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self.rate: Dict[str, float] = {}
        self._t0: Dict[str, float] = {}

    def start(self, name: str = "step"):
        self._t0[name] = time.time()

    def stop(self, name: str = "step", units: float = 1.0) -> float:
        dt = time.time() - self._t0[name]
        r = units / dt if dt > 0 else 0.0
        prev = self.rate.get(name)
        self.rate[name] = r if prev is None else \
            (1 - self.alpha) * prev + self.alpha * r
        return r


def time_ms(fn, reps=20, repeats=7):
    """(device ms, host ms) per call of ``fn`` on the CUDA card. Device:
    ``reps`` calls captured in one CUDA graph, replayed ``repeats`` times,
    timed with CUDA events, median per call; the host's launch overhead is
    not in it. Host: median of single eager calls timed with CUDA events,
    which includes the time the card waits for Python to launch the work.
    ``fn`` must not sync with the host (a graph cannot hold that)."""
    side = torch.cuda.Stream()              # warm up off the default stream,
    side.wait_stream(torch.cuda.current_stream())   # as capture wants
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()

    def timed(call, per):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / per

    device = sorted(timed(graph.replay, reps) for _ in range(repeats))
    host = sorted(timed(fn, 1) for _ in range(reps))
    del graph
    return device[len(device) // 2], host[len(host) // 2]


def eager_ms(fn, reps=5):
    """Median ms of single eager calls of ``fn`` timed with CUDA events
    (for work that syncs with the host, which a CUDA graph cannot hold)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[reps // 2]


def host_ms(fn, warmup=2, iters=20):
    """Mean ms per call of ``fn`` on the host clock (the CPU's timer; on a
    CUDA card it would measure the enqueue, so the card uses ``time_ms``
    or ``eager_ms``)."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def _device_times(prof):
    """({kernel name: device µs}, {kernel name: count}) of a finished
    ``torch.profiler`` run on the CUDA card."""
    from torch.autograd import DeviceType
    by_name, count = {}, {}
    # the raw events: building the profiler's event tree of a step's CPU
    # ops took most of a minute for 20 TGAT steps; device work only, no
    # memory records, no user annotations (``Optimizer.step#...`` spans
    # kernels, not one)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA and \
                not e.is_user_annotation() and not e.is_hidden_event() and \
                name not in ("[memory]", "[OutOfMemory]"):
            by_name[name] = by_name.get(name, 0.0) + e.duration_ns() / 1e3
            count[name] = count.get(name, 0) + 1
    return by_name, count


def busy_ms(fn, reps=5):
    """Device-busy ms per call of ``fn`` on the CUDA card: the summed
    duration of the kernels, copies and sets that ``torch.profiler`` saw
    over ``reps`` eager calls (after one warm-up call). For work that a
    CUDA graph cannot hold; the host's launch gaps are not in it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name, _ = _device_times(prof)
    if not by_name:
        raise RuntimeError("the profiler saw no device time")
    return sum(by_name.values()) / reps / 1e3


def profile_steps(run, n_steps=20, log=print):
    """Trace ``n_steps`` calls of ``run(i)`` with ``torch.profiler`` on the
    CUDA card and ``log`` the device's busy share of the window, the
    kernels that took the most device time and the port's own kernels.
    Returns ``{"wall_ms", "busy_ms", "idle", "kernels"}`` per step (None
    when the profiler saw no device time). The launches made here count
    for no path."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_steps):
            run(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name, count = _device_times(prof)
    busy = sum(by_name.values())
    if not by_name:
        log("  the profiler saw no device time")
        return None
    log(f"  {n_steps} steps traced: wall {wall_us / n_steps / 1e3:.3f} "
        f"ms/step, device busy {busy / n_steps / 1e3:.3f} ms/step, idle "
        f"share {1 - busy / wall_us:.3f}, {sum(count.values()) / n_steps:.0f} "
        f"kernels/step")
    ranked = sorted(by_name.items(), key=lambda x: -x[1])
    # the twelve largest, then the port's own kernels further down
    port = [x for x in ranked[12:] if any(
        k in x[0] for k in ("attend", "sample_", "w2e_"))]
    for name, us in ranked[:12] + port:
        log(f"    {us / n_steps:9.1f} us/step {count[name] / n_steps:5.1f}x "
            f"{name[:90]}")
    return {"wall_ms": wall_us / n_steps / 1e3,
            "busy_ms": busy / n_steps / 1e3, "idle": 1 - busy / wall_us,
            "kernels": sum(count.values()) / n_steps}
