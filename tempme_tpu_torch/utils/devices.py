"""Device resolution for the port's entry points.

An entry point runs on the CUDA device unless the caller asks for the CPU.
Without a CUDA device and without ``device="cpu"`` it raises: nothing falls
back to the CPU quietly.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a CUDA device); otherwise the
    named device. Also turns TF32 off, so float32 matmuls and convolutions
    keep full float32 precision as in the JAX reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
