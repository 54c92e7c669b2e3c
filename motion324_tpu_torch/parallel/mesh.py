"""The ``(dp, mp)`` mesh of process groups (counterpart of
``motion324_tpu/parallel/mesh.py``).

Ranks are laid out as the JAX package lays out devices: rank
``d * mp + m`` sits at ``(d, m)``. Its ``dp`` group holds the ranks with
its ``m`` (one model shard each, the data-parallel replicas), its ``mp``
group the ranks with its ``d`` (one model replica, split by tensor or
sequence parallelism). Every collective of the port takes one of these
:class:`Group`\\ s.
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist

from motion324_tpu_torch.parallel.distributed import is_initialized

__all__ = ["Group", "Mesh", "make_mesh", "local_batch_size"]


@dataclasses.dataclass(frozen=True)
class Group:
    """A process group and this process's place in it. ``group=None`` is a
    run without a process group (one process): collectives do nothing."""

    group: object | None = None
    rank: int = 0
    size: int = 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    dp: Group
    mp: Group

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": self.dp.size, "mp": self.mp.size}


def make_mesh(dp: int = -1, mp: int = 1) -> Mesh:
    """The ``(dp, mp)`` mesh over the world's ranks; ``dp=-1`` takes every
    rank that ``mp`` leaves. Without a process group the world is one
    process and the mesh's groups do nothing. Every rank must call this
    (it creates the groups)."""
    n = dist.get_world_size() if is_initialized() else 1
    if dp == -1:
        if n % mp:
            raise ValueError(f"{n} devices not divisible by mp={mp}")
        dp = n // mp
    if dp * mp != n:
        raise ValueError(f"dp*mp = {dp}*{mp} != {n} devices")
    if not is_initialized():
        return Mesh(Group(), Group())
    rank = dist.get_rank()
    d, m = divmod(rank, mp)

    def group(ranks: list[int]) -> object:
        # every rank creates every group, in the same order
        return dist.group.WORLD if len(ranks) == n else dist.new_group(ranks)

    dp_groups = [group([i * mp + j for i in range(dp)]) for j in range(mp)]
    mp_groups = [group([i * mp + j for j in range(mp)]) for i in range(dp)]
    return Mesh(Group(dp_groups[m], d, dp), Group(mp_groups[d], m, mp))


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    dp = mesh.dp.size
    if global_batch % dp:
        raise ValueError(f"global batch {global_batch} not divisible by dp={dp}")
    return global_batch // dp
