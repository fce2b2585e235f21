"""The port stands alone: no JAX, no flax, no ``tempme_tpu`` import, and no
quiet fall back to the CPU."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "tempme_tpu")


def _port_files():
    files = sorted((ROOT / "tempme_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_flax_or_reference_package():
    files = _port_files()
    assert len(files) > 15
    bad = [(f.relative_to(ROOT), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_entry_points_raise_without_cuda(monkeypatch):
    from tempme_tpu_torch.data.events import EventStream
    from tempme_tpu_torch.data.graph import build_temporal_graph
    from tempme_tpu_torch.models.tgn import TGN, init_memory_state
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ev = EventStream(np.array([1], np.int32), np.array([2], np.int32),
                     np.array([1.0], np.float32), np.zeros(1, np.float32),
                     np.array([1], np.int32))
    for call in (lambda: build_temporal_graph(ev),
                 lambda: TGN(8, 4, 3),
                 lambda: init_memory_state(3, 8, 28),
                 lambda: build_temporal_graph(ev, device="cuda")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert build_temporal_graph(ev, device="cpu").off.device.type == "cpu"


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card_or_the_port(tmp_path):
    res = _run_smoke(ROOT)
    assert res.returncode != 0 and '"ok"' not in res.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0 and '"ok"' not in res.stdout
