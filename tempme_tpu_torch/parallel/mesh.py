"""The ('dp', 'sp', 'tp') mesh over the current process group.

Port of ``tempme_tpu/parallel/mesh.py``. The JAX mesh names three axes:
``dp`` shards the event batch, ``sp`` the neighbour/walk support axis and
the TGN memory's rows, ``tp`` the feature axis; XLA inserts the collectives
from the shardings. Here one process is one rank of ``dp``: each rank holds
the whole replicated state (parameters, Adam state, memory, generator) and
runs the step on its contiguous slice of every global batch, and the step
(``parallel/train.py``) makes its collectives itself.

``sp`` and ``tp`` above 1 raise ``ValueError``: the row-sharded memory and
the feature-sharded tables need a design of their own first (ROADMAP A16,
the sp/tp design). So the JAX helpers that place arrays on the mesh
(``batch_sharding``, ``support_sharding``, ``feature_sharding``,
``memory_sharding``, ``replicated``, ``shard_params_tp``) have no
counterpart: under replicated-state dp every tensor is either replicated
or this rank's own rows, and the step and ``multihost.iter_global_batches``
place them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch.distributed as dist

AXES = ("dp", "sp", "tp")


def factorize(n: int) -> Tuple[int, int, int]:
    """The JAX package's default (dp, sp, tp) for n devices: favour dp,
    give sp a factor of 2 when available, tp last. The port runs only
    (n, 1, 1) of these (``make_mesh``)."""
    if n == 1:
        return 1, 1, 1
    sp = 2 if n % 2 == 0 else 1
    rem = n // sp
    tp = 2 if rem % 2 == 0 and rem > 2 else 1
    dp = rem // tp
    return dp, sp, tp


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A dp mesh: this process's ``rank`` of ``dp`` over ``group`` (None:
    one process, no process group, no collectives)."""
    dp: int
    sp: int
    tp: int
    rank: int
    group: Optional[object] = None

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, (self.dp, self.sp, self.tp)))

    @property
    def size(self) -> int:
        return self.dp * self.sp * self.tp


def make_mesh(dp: int = 0, sp: int = 1, tp: int = 1) -> Mesh:
    """The mesh over the initialised process group (without one, a
    1-process mesh). ``dp=0`` means every process."""
    if sp != 1 or tp != 1:
        raise ValueError(
            f"mesh sp={sp} tp={tp}: only data parallelism (dp) runs in the "
            f"port; the sp and tp axes (the row-sharded TGN memory, the "
            f"feature-sharded tables) wait for ROADMAP.md A16's sp/tp design")
    group = None
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
        world, rank = dist.get_world_size(group), dist.get_rank(group)
    else:
        world, rank = 1, 0
    dp = dp or world
    if dp != world:
        raise ValueError(f"mesh dp={dp} over a group of {world} processes")
    return Mesh(dp, 1, 1, rank, group)
