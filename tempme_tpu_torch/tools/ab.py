"""What the old-against-new kernel tools (``attend_ab``, ``walk_ab``) share:
building another checkout's CUDA sources, and timing calls in turns on one
card.

Another build is compiled with ``_build.py``'s ``nvcc`` flags into a
temporary directory, one ``nvcc`` per source, all started together, with the
other sources' directory on the include path (for their shared headers).
Each call is timed six times in turns, plain, other, this, this, other,
plain: device ms per call of 20 calls captured in one CUDA graph, the median
of 7 replays, as ``chip_smoke.py`` times kernels.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess

import torch

from ..ops.kernels import _build

ORDER = ("plain", "other", "this", "this", "other", "plain")


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def build_other(csrc: str, names, out_dir: str) -> dict:
    """{name: CDLL} of ``csrc``'s ``<name>.cu`` for each name."""
    procs = {}
    for name in names:
        lib = os.path.join(out_dir, f"lib{name}_other.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", lib,
               os.path.join(csrc, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs, failed = {}, []
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- the other {name}.cu\n{log}")
            continue
        libs[name] = ctypes.CDLL(lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return libs


def device_ms(fn, reps=20, repeats=7):
    """Device ms per call: ``reps`` calls in one CUDA graph, replayed
    ``repeats`` times, median."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return sorted(times)[len(times) // 2]


def in_turns(calls: dict) -> dict:
    """{build: [ms, ms]} of ``calls`` ({"plain", "other", "this": fn})
    timed in the order ``ORDER``."""
    times = {b: [] for b in calls}
    for b in ORDER:
        times[b].append(device_ms(calls[b]))
    return times


def turns_text(times: dict) -> str:
    return ", ".join(f"{b} {t[0]:.4f} / {t[1]:.4f}"
                     for b, t in times.items()) + " ms"


def write_json(path: str, card: str, rows: list) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
