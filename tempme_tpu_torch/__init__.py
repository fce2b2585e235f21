"""tempme_tpu_torch: the PyTorch/CUDA port of ``tempme_tpu``.

Module names mirror the JAX package so each counterpart is easy to find.
This package imports ``torch`` and numpy only; the JAX package is its
reference and is never imported here. Entry points run on the CUDA device
unless the caller passes ``device="cpu"`` (``utils/devices.py``).
"""
