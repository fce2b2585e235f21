"""ctypes bindings for the native host runtime (``native/tempme_host.cpp``).

Port of ``tempme_tpu/utils/native.py``: a CSV event loader, a CSR builder
and exact-semantics host samplers (temporal neighbours, motif-walk
continuations), over numpy arrays. The port keeps its own copy of the C++
source (``tempme_tpu_torch/native/tempme_host.cpp``). It is compiled with
g++ at first use into ``tempme_tpu_torch/_build/``, under a name keyed by
the hash of the source and the flags, so an edited source is rebuilt.
Without a toolchain the entry points raise; ``available()`` is the guard
for callers. No driver calls this module: the card's path samples with the
CUDA kernels, and the data layer loads with numpy.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parents[1] / "native" / "tempme_host.cpp"
_BUILD = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(_FLAGS).encode()).hexdigest()
    return _BUILD / f"libtempme_host-{digest[:16]}.so"


def _build(out: Path) -> bool:
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, "-o", str(tmp), str(_SRC)]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        err = getattr(e, "stderr", b"")
        print(f"[native] build failed: {err.decode() if err else e}")
        return False
    os.replace(tmp, out)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = library_path()
    if not so.exists() and not _build(so):
        return None
    lib = ctypes.CDLL(str(so))
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.th_load_csv.restype = ctypes.c_int64
    lib.th_load_csv.argtypes = [ctypes.c_char_p, ctypes.c_int64, i32p, i32p,
                                f32p, f32p, i32p]
    lib.th_build_csr.restype = None
    lib.th_build_csr.argtypes = [ctypes.c_int64, i32p, i32p, i32p, f32p,
                                 ctypes.c_int64, i32p, i32p, f32p, i64p]
    lib.th_sample_neighbors.restype = None
    lib.th_sample_neighbors.argtypes = [i32p, i32p, f32p, i64p,
                                        ctypes.c_int64, i32p, f32p,
                                        ctypes.c_int32, ctypes.c_uint64,
                                        i32p, i32p, f32p]
    lib.th_sample_walks.restype = None
    lib.th_sample_walks.argtypes = [i32p, i32p, f32p, i64p, f32p,
                                    ctypes.c_int64, i32p, i32p, i32p,
                                    ctypes.c_uint64, i32p, f32p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("the native host runtime did not build (g++ "
                           "with OpenMP is needed); check available()")
    return lib


def load_csv(path: str):
    """Fast ml_{name}.csv parser -> (src, dst, ts, label, eidx)."""
    lib = _lib_or_raise()
    empty_i = np.empty(0, np.int32)
    empty_f = np.empty(0, np.float32)
    n = lib.th_load_csv(path.encode(), 0, empty_i, empty_i, empty_f, empty_f,
                        empty_i)
    if n < 0:
        raise IOError(f"cannot read {path}")
    src = np.empty(n, np.int32)
    dst = np.empty(n, np.int32)
    ts = np.empty(n, np.float32)
    label = np.empty(n, np.float32)
    eidx = np.empty(n, np.int32)
    got = lib.th_load_csv(path.encode(), n, src, dst, ts, label, eidx)
    if got < n:
        raise IOError(f"{path} changed while it was read")
    return src, dst, ts, label, eidx


class HostGraph:
    """Host-side CSR adjacency + exact-semantics samplers (native)."""

    def __init__(self, src, dst, eidx, ts, num_nodes: int, num_edges: int):
        lib = _lib_or_raise()
        self._lib = lib
        n = len(src)
        t = 2 * n
        self.ngh = np.empty(t, np.int32)
        self.eid = np.empty(t, np.int32)
        self.ts = np.empty(t, np.float32)
        self.off = np.empty(num_nodes + 1, np.int64)
        lib.th_build_csr(n, np.ascontiguousarray(src, np.int32),
                         np.ascontiguousarray(dst, np.int32),
                         np.ascontiguousarray(eidx, np.int32),
                         np.ascontiguousarray(ts, np.float32),
                         num_nodes, self.ngh, self.eid, self.ts, self.off)
        self.edge_ts = np.zeros(num_edges, np.float32)
        self.edge_ts[np.asarray(eidx)] = np.asarray(ts)

    def sample_neighbors(self, nodes, times, n: int, seed: int = 0
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        q = len(nodes)
        out_n = np.empty((q, n), np.int32)
        out_e = np.empty((q, n), np.int32)
        out_t = np.empty((q, n), np.float32)
        self._lib.th_sample_neighbors(
            self.ngh, self.eid, self.ts, self.off, q,
            np.ascontiguousarray(nodes, np.int32),
            np.ascontiguousarray(times, np.float32), n, seed,
            out_n, out_e, out_t)
        return out_n, out_e, out_t

    def sample_walks(self, s1, u1, e1, seed: int = 0):
        """Flattened walk continuation: per (s1, u1, e1) row, events 2 and 3
        plus the (x, t) anonymous code.
        Returns int out [W, 8] = (s2,u2,e2,s3,u3,e3,x,t) and ts [W, 2]."""
        w = len(s1)
        out = np.empty((w, 8), np.int32)
        out_t = np.empty((w, 2), np.float32)
        self._lib.th_sample_walks(
            self.ngh, self.eid, self.ts, self.off, self.edge_ts, w,
            np.ascontiguousarray(s1, np.int32),
            np.ascontiguousarray(u1, np.int32),
            np.ascontiguousarray(e1, np.int32), seed, out, out_t)
        return out, out_t
