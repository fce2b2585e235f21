"""Debug mode: numeric-fault detection and finiteness checks.

Port of ``tempme_tpu/utils/debug.py``. Enable it with ``TEMPME_DEBUG=1``:
the training drivers (``train/learn_base.py``, ``train/learn_tgn.py``)
then call ``install()`` before the epoch loop and, after each epoch,
``check_finite`` on the parameters (and a TGN's memory).

* numeric faults -- ``install()`` turns on autograd's anomaly mode with
  ``check_nan``: a backward function that returns NaN raises, naming the
  forward operation that made it (with its traceback). It checks the
  backward's outputs only. ``jax_debug_nans``/``jax_debug_infs`` check
  every primitive's forward outputs too, and infinities; here the forward
  is covered by the epoch-end ``check_finite``.
* finiteness -- ``check_finite(tensors_or_module, where)`` scans on the
  host and names the first offending tensor by its state-dict path.

* collectives -- ``count_collectives(step)`` reads a data-parallel step's
  collectives of its last call by kind (``parallel/train.py``: the JAX
  module counts them in the compiled HLO; here the step makes them
  itself and counts them as it does), and ``assert_collectives(step,
  golden, where)`` holds them to a committed golden
  (``parallel/train.py::GOLDEN_COLLECTIVES``), so that a changed design
  fails loudly.

``assert_donated`` has no counterpart: it verifies that XLA consumed a
jitted call's donated buffers; PyTorch has no buffer donation (its steps
update parameters in place), so there is nothing to verify.
"""
from __future__ import annotations

import contextlib
import os

import torch


def enabled() -> bool:
    return os.environ.get("TEMPME_DEBUG", "") == "1"


def install() -> None:
    """Turn on autograd's anomaly detection with its NaN check (debug mode
    only: it records a traceback per forward operation, so it costs
    throughput). It stays on for the process; ``restored`` scopes it."""
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    print("[debug] TEMPME_DEBUG=1: autograd anomaly detection (NaN in "
          "backward) on, finiteness checks active")


@contextlib.contextmanager
def restored():
    """On exit, set autograd's anomaly mode back to what it was on entry
    (a driver called from Python leaves its caller's mode as it was)."""
    prev = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(*prev)


def _named(tree, prefix=""):
    """(path, tensor) pairs of a module (its state dict), a NamedTuple, a
    dict, a list or tuple, or one tensor."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, torch.Tensor):
        yield prefix or "tensor", tree
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _named(v, f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}[{i}]")


def check_finite(tree, where: str) -> None:
    """Host-side finiteness scan of every floating tensor in ``tree`` (a
    module, a NamedTuple, dict, list or tuple of tensors, or a tensor);
    raises ``FloatingPointError`` naming the first offending one by its
    path and its count of bad values."""
    for path, t in _named(tree):
        if not (t.is_floating_point() or t.is_complex()):
            continue
        bad = int((~torch.isfinite(t.detach())).sum())
        if bad:
            raise FloatingPointError(
                f"[debug] non-finite values in {where} at {path}: "
                f"{bad}/{t.numel()} bad")


def count_collectives(step) -> dict:
    """The collectives of a data-parallel step's last call on this rank,
    by kind (``all_gather``, ``all_reduce``, ``broadcast``): its
    ``comm.by_kind`` (the step's caller resets ``comm`` before the call,
    as ``parallel/dryrun.py`` does)."""
    return dict(step.comm.by_kind)


def assert_collectives(step, golden: dict, where: str = "") -> None:
    """Hold a data-parallel step's collectives of its last call to a
    committed golden (``parallel/train.py::GOLDEN_COLLECTIVES``; change
    the golden with the design that changes them)."""
    got = count_collectives(step)
    if got != dict(golden):
        raise AssertionError(
            f"[debug] collective counts drifted in {where or 'step'}: got "
            f"{got}, golden {dict(golden)}; if the design changed on "
            f"purpose, change parallel/train.py::GOLDEN_COLLECTIVES with it")
