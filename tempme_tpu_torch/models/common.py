"""Frozen feature tables passed explicitly to the models."""
from __future__ import annotations

from typing import NamedTuple

import torch


class Features(NamedTuple):
    node: torch.Tensor   # [N, Dn] float32, row 0 = padding zeros
    edge: torch.Tensor   # [E, De] float32, row 0 = padding zeros
