"""The ('dp', 'sp', 'tp') mesh over the current process group.

Port of ``tempme_tpu/parallel/mesh.py``. The JAX mesh names three axes:
``dp`` shards the event batch, ``sp`` the neighbour support axis and the
TGN memory's rows, ``tp`` the Dense kernels' output axis; XLA inserts the
collectives from the shardings. Here one process is one rank; rank ``r``
sits at the coordinates ``(d, s, t)`` of ``r`` in ``np.arange(n).reshape(dp,
sp, tp)``, the layout of JAX's ``make_mesh`` (``mesh_coords``), and the step
(``parallel/train.py``) makes its collectives itself over the rank's
subgroups (``mesh_groups``):

* ``dp``: the ranks with this rank's (s, t); they hold different batch
  rows (``multihost.local_slice`` cuts by ``d``) and exchange the rows
  the memory write reads;
* ``sp``: the ranks with this rank's (d, t); they hold the same batch
  rows, different contiguous blocks of the memory's rows
  (``row_block``) and different column chunks of each hop's support;
* ``tp``: the ranks with this rank's (d, s); they hold different row
  blocks of each tp-sharded weight (``tp_sharded``) and its Adam moments;
* ``peers``: the ranks with this rank's t (dp x sp of them), over which a
  tp shard's gradient is summed.

The JAX helpers that place arrays (``batch_sharding``, ``support_sharding``,
``memory_sharding``, ``shard_params_tp``) have their counterparts in the
step and in ``row_block``/``tp_sharded``: a tensor is either replicated or
this rank's own block.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch.distributed as dist

AXES = ("dp", "sp", "tp")
# the subgroups a rank holds: the three axes, and the ranks sharing its tp
# index (dp x sp), which sum a tp shard's gradient
GROUPS = AXES + ("peers",)


def factorize(n: int) -> Tuple[int, int, int]:
    """The JAX package's default (dp, sp, tp) for n devices: favour dp,
    give sp a factor of 2 when available, tp last."""
    if n == 1:
        return 1, 1, 1
    sp = 2 if n % 2 == 0 else 1
    rem = n // sp
    tp = 2 if rem % 2 == 0 and rem > 2 else 1
    dp = rem // tp
    return dp, sp, tp


def mesh_coords(rank: int, dp: int, sp: int, tp: int) -> Tuple[int, int, int]:
    """Rank ``rank``'s (d, s, t): its place in ``np.arange(dp * sp *
    tp).reshape(dp, sp, tp)``."""
    return tuple(int(i) for i in np.unravel_index(rank, (dp, sp, tp)))


def mesh_groups(dp: int, sp: int, tp: int) -> dict:
    """Every subgroup of the mesh by kind (``GROUPS``), each a list of
    rank lists, in the order every rank creates them."""
    arr = np.arange(dp * sp * tp).reshape(dp, sp, tp)
    return {
        "dp": [arr[:, s, t].tolist() for s in range(sp) for t in range(tp)],
        "sp": [arr[d, :, t].tolist() for d in range(dp) for t in range(tp)],
        "tp": [arr[d, s, :].tolist() for d in range(dp) for s in range(sp)],
        "peers": [arr[:, :, t].ravel().tolist() for t in range(tp)]}


def row_block(num_rows: int, sp: int, s: int) -> Tuple[int, int]:
    """(first row, rows) of sp rank ``s``'s contiguous block of a table of
    ``num_rows`` rows: ``ceil(num_rows / sp)`` rows a block, the last one
    padded past the table's end."""
    rows = -(-num_rows // sp)
    return s * rows, rows


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's ``rank`` of a ``dp x sp x tp`` mesh over ``group``
    (the world; None: one process, no collectives) and ``groups`` (its
    subgroups by kind, ``GROUPS``; None where the mesh is dp alone, whose
    dp group is the world)."""
    dp: int
    sp: int
    tp: int
    rank: int
    group: Optional[object] = None
    groups: Optional[dict] = None

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, (self.dp, self.sp, self.tp)))

    @property
    def size(self) -> int:
        return self.dp * self.sp * self.tp

    @property
    def coords(self) -> Tuple[int, int, int]:
        return mesh_coords(self.rank, self.dp, self.sp, self.tp)

    def axis_size(self, axis: str) -> int:
        """The ranks of ``axis`` (``world`` or one of ``GROUPS``)."""
        return {"world": self.size, "dp": self.dp, "sp": self.sp,
                "tp": self.tp, "peers": self.dp * self.sp}[axis]

    def axis_group(self, axis: str):
        """The process group of ``axis``; None where it holds one rank."""
        n = self.axis_size(axis)
        if n == 1:
            return None
        if n == self.size:
            return self.group
        return self.groups[axis]


def make_mesh(dp: int = 0, sp: int = 1, tp: int = 1) -> Mesh:
    """The mesh over the initialised process group (without one, a
    1-process mesh); ``dp=0`` means the rest of the processes. Every rank
    must call it with the same arguments: it creates every subgroup, each
    on every rank, in one order (``mesh_groups``)."""
    if min(sp, tp) < 1 or dp < 0:
        raise ValueError(f"mesh dp={dp} sp={sp} tp={tp}")
    group = None
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
        world, rank = dist.get_world_size(group), dist.get_rank(group)
    else:
        world, rank = 1, 0
    if dp == 0:
        if world % (sp * tp):
            raise ValueError(f"mesh sp={sp} tp={tp} does not divide a group "
                             f"of {world} processes")
        dp = world // (sp * tp)
    if dp * sp * tp != world:
        raise ValueError(f"mesh dp={dp} sp={sp} tp={tp} over a group of "
                         f"{world} processes")
    groups = None
    if sp > 1 or tp > 1:
        groups = {}
        for kind, lists in mesh_groups(dp, sp, tp).items():
            for ranks in lists:
                if 1 < len(ranks) < world:
                    g = dist.new_group(ranks=ranks)
                    if rank in ranks:
                        groups[kind] = g
    return Mesh(dp, sp, tp, rank, group, groups)
