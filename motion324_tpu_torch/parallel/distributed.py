"""Process-group start-up from the launcher's environment.

The reference starts one NCCL process per card from torchrun's variables
(reference ``setup.py:94-162``); the JAX package reads its coordinator from
``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID`` or
their ``MOTION324_*`` aliases. :func:`init_distributed` reads either set:

- ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` /
  ``MASTER_PORT`` (``torchrun --nproc-per-node N``);
- ``MOTION324_PROCESS_ID`` / ``MOTION324_NUM_PROCESSES`` /
  ``MOTION324_COORDINATOR`` (``host:port``), and the ``JAX_*`` names.

With no such variables the run is one process and no group is made.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from motion324_tpu_torch import resolve_device

__all__ = ["init_distributed", "process_seed", "destroy", "local_device",
           "is_initialized"]


def _env(*names, default=None):
    for n in names:
        v = os.environ.get(n)
        if v is not None:
            return v
    return default


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def local_device(device=None) -> torch.device:
    """This process's device: ``device`` if given (``"cpu"`` for the CPU),
    else ``cuda:LOCAL_RANK`` (``cuda:0`` without a launcher). Raises when
    CUDA is asked for and there is no card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(_env("LOCAL_RANK", default=0)))
    return dev


def init_distributed(backend: str | None = None,
                     device=None) -> tuple[int, int]:
    """Join the process group the launcher's environment describes and
    return ``(rank, world_size)``; ``(0, 1)`` with no group when the
    environment names none. An existing group is kept.

    The backend is ``nccl`` on a card (the process's card is
    ``cuda:LOCAL_RANK``) and ``gloo`` when ``device="cpu"``; an explicit
    ``backend`` wins (``"gloo"`` runs several processes on one card)."""
    if is_initialized():
        return dist.get_rank(), dist.get_world_size()
    world = _env("WORLD_SIZE", "MOTION324_NUM_PROCESSES", "JAX_NUM_PROCESSES")
    rank = _env("RANK", "MOTION324_PROCESS_ID", "JAX_PROCESS_ID")
    if world is None or rank is None:
        return 0, 1
    world, rank = int(world), int(rank)
    dev = local_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    addr = _env("MASTER_ADDR")
    port = _env("MASTER_PORT")
    if addr is None or port is None:
        coord = _env("MOTION324_COORDINATOR", "JAX_COORDINATOR_ADDRESS")
        if coord is None:
            raise RuntimeError("RANK and WORLD_SIZE are set but neither "
                               "MASTER_ADDR/MASTER_PORT nor "
                               "MOTION324_COORDINATOR names the coordinator")
        addr, _, port = coord.rpartition(":")
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kw["device_id"] = dev
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            rank=rank, world_size=world, **kw)
    return rank, world


def process_seed(base_seed: int, index: int | None = None) -> int:
    """Per-process seed: ``base + index`` (reference ``setup.py:125``);
    ``index`` defaults to the process's rank. A trainer with tensor
    parallelism passes its data-parallel index, so that the ranks of one
    model replica draw the same batch."""
    if index is None:
        index = dist.get_rank() if is_initialized() else 0
    return int(base_seed) + int(index)


def destroy() -> None:
    """Leave the process group, if there is one."""
    if is_initialized():
        dist.destroy_process_group()
