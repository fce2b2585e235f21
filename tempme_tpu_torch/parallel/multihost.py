"""Processes, devices and the edge-partitioned input pipeline.

Port of ``tempme_tpu/parallel/multihost.py``. ``initialize`` joins the
``torch.distributed`` process group and returns this rank's device; the
backend is the caller's choice and nothing switches it: ``nccl`` on CUDA
(one card a rank), ``gloo`` on the CPU, and ``gloo`` with CUDA tensors
where ranks share one card. Under ``nccl``, two ranks on one card raise a
``ValueError`` that names gloo (NCCL itself refuses them).

The event stream is partitioned by batch position, as in the JAX package:
every rank computes the same global ``np.random.RandomState(seed)``
shuffle (as ``train/loops.py::epoch_order``) and keeps only its dp index's
contiguous slice of each global batch (``local_slice``), so no rank reads
the events of another dp index.
"""
from __future__ import annotations

import os
import socket
from typing import Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..train import loops
from ..utils.devices import resolve_device

BACKENDS = ("nccl", "gloo")


def rank_device(backend: str, local_rank: int, device=None) -> torch.device:
    """This rank's device: ``device`` if given (a card without an index:
    the current one), else the card ``cuda:{local_rank}`` under nccl and
    ``cuda:{local_rank % cards}`` under gloo (ranks may share a card
    there). A CPU device, or a local rank without a card of its own, under
    nccl raises."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    if device is None:
        resolve_device(None)                 # raises without a CUDA device
        cards = torch.cuda.device_count()
        if backend == "nccl" and local_rank >= cards:
            raise ValueError(
                f"nccl: local rank {local_rank} needs a card of its own and "
                f"this host has {cards}; NCCL refuses two ranks on one "
                f"card, so run ranks that share a card over gloo with CUDA "
                f"tensors (backend='gloo')")
        index = local_rank if backend == "nccl" else local_rank % cards
        device = f"cuda:{index}"
    dev = resolve_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("nccl moves CUDA tensors only; run on the CPU over "
                         "gloo (backend='gloo', device='cpu')")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_placement(backend: str, seats) -> None:
    """``seats``: every rank's card, in rank order (any hashable that
    tells cards apart, such as (host, UUID)). Under nccl two ranks on one
    card raise."""
    if backend != "nccl":
        return
    first = {}
    for rank, seat in enumerate(seats):
        if seat in first:
            raise ValueError(
                f"nccl: ranks {first[seat]} and {rank} are on the same card "
                f"({seat}), which NCCL refuses; run ranks that share a card "
                f"over gloo with CUDA tensors (backend='gloo'), or give each "
                f"rank a card of its own")
        first[seat] = rank


def _seat(dev: torch.device):
    props = torch.cuda.get_device_properties(dev)
    return socket.gethostname(), str(getattr(props, "uuid", dev.index))


def initialize(backend: str, init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               device=None) -> torch.device:
    """Join the process group; returns this rank's device (``rank_device``;
    under CUDA it becomes the current device). Explicit arguments win over
    torchrun's ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``
    and ``LOCAL_RANK``."""
    env = os.environ
    world_size = int(world_size if world_size is not None
                     else env["WORLD_SIZE"])
    rank = int(rank if rank is not None else env["RANK"])
    local_rank = int(env.get("LOCAL_RANK", rank))
    if init_method is None:
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    dev = rank_device(backend, local_rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            device_id=dev if backend == "nccl" else None)
    if backend == "nccl" and world_size > 1:
        side = dist.new_group(backend="gloo")
        seats = [None] * world_size
        dist.all_gather_object(seats, _seat(dev), group=side)
        dist.destroy_process_group(side)
        try:
            check_placement(backend, seats)
        except ValueError:
            dist.destroy_process_group()
            raise
    return dev


def local_slice(batch_size: int, rank: Optional[int] = None,
                world_size: Optional[int] = None, mesh=None) -> slice:
    """This rank's contiguous slice of every global [B] batch: the
    ``rank``-th of ``world_size`` (the process group's rank and size unless
    given), or with ``mesh`` its dp index's of ``dp`` (the ranks of one
    dp index, over sp and tp, hold the same rows)."""
    if mesh is not None:
        rank, world_size = mesh.coords[0], mesh.dp
    live = dist.is_available() and dist.is_initialized()
    if world_size is None:
        world_size = dist.get_world_size() if live else 1
    if rank is None:
        rank = dist.get_rank() if live else 0
    if batch_size % world_size:
        raise ValueError(f"batch {batch_size} does not split over "
                         f"{world_size} ranks")
    per = batch_size // world_size
    return slice(rank * per, (rank + 1) * per)


def iter_global_batches(events, batch_size: int, shuffle: bool, seed: int,
                        drop_remainder: bool = True, device=None,
                        rank: Optional[int] = None,
                        world_size: Optional[int] = None, mesh=None
                        ) -> Iterator[loops.Batch]:
    """This rank's slices of the epoch's global batches, as tensors on
    ``device`` (the card unless the caller asks for the CPU). With
    ``drop_remainder=False`` a short final chunk is padded with event 0 and
    ``mask=False`` (the step routes those rows to the padding node). The
    slices of all dp indices, concatenated in order, are the JAX package's
    global batches (``rank``, ``world_size`` and ``mesh`` as in
    ``local_slice``)."""
    dev = resolve_device(device)
    n = len(events)
    idx = np.arange(n)
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    sl = local_slice(batch_size, rank, world_size, mesh)

    def local(x):
        return torch.from_numpy(np.ascontiguousarray(x[sl])).to(dev)

    stop = (n - batch_size + 1) if drop_remainder else n
    for s in range(0, stop, batch_size):
        chunk = idx[s:s + batch_size]
        mask = np.ones(batch_size, bool)
        if len(chunk) < batch_size:
            mask[len(chunk):] = False
            chunk = np.r_[chunk, np.zeros(batch_size - len(chunk), np.int64)]
        yield loops.Batch(*(local(x[chunk]) for x in (
            events.src, events.dst, events.ts, events.e_idx)),
            mask=local(mask))


def sync(tag: str) -> None:
    """A barrier of every rank (nothing without a process group); a
    failure names ``tag``."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    try:
        dist.barrier()
    except RuntimeError as e:
        raise RuntimeError(f"sync {tag!r}: {e}") from e
