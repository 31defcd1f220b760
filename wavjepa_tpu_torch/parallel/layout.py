"""Where this process sits in the run: its rank and world size, and its
place in the (data, model) layout of tensor parallelism.

The JAX package's ``make_mesh(n, model_parallel)`` reshapes the devices to
(n / mp, mp), so device ``r`` sits at data ``r // mp`` and model ``r % mp``;
the port's ranks are laid out the same way (``parallel/mesh.init_layout``
makes their groups). This module reads the torch.distributed group without
importing torch, so that the data pipeline, whose worker processes never
load torch, can ask which rows and shards are its own.
"""

from __future__ import annotations

import sys

_MODEL_PARALLEL = [1]  # ranks of one tensor-parallel group, set by mesh.init_layout


def process_group() -> tuple[int, int]:
    """(rank, world size) of the initialised torch.distributed process
    group, else (0, 1). Such a group exists only where torch was imported,
    so this module looks for it without importing torch."""
    torch = sys.modules.get("torch")
    dist = getattr(torch, "distributed", None)
    if dist is not None and dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def model_parallel() -> int:
    """The run's tensor-parallel size (1 until ``mesh.init_layout`` sets
    another, and always 1 without a process group)."""
    return _MODEL_PARALLEL[0] if process_group()[1] > 1 else 1


def set_model_parallel(mp: int) -> None:
    _MODEL_PARALLEL[0] = mp


def data_world(world: int, mp: int) -> int:
    """The data-parallel ranks of a run of ``world`` ranks at
    ``trainer.model_parallel`` ``mp``: world / mp. Raises where mp does not
    divide the world (alone, mp > 1 is told to launch with torchrun)."""
    if mp < 1 or world % mp:
        raise ValueError(
            f"trainer.model_parallel={mp} does not divide the {world} rank(s) of this run"
            + (f": launch it with torchrun --nproc_per_node={mp}" if world == 1 and mp > 1
               else ""))
    return world // mp


def data_group() -> tuple[int, int]:
    """(data-parallel rank, data-parallel world): which replica of the model
    this rank belongs to, of how many. Every rank of one tensor-parallel
    group has the same data rank, and so takes the same rows. (0, 1)
    without a process group."""
    rank, world = process_group()
    mp = model_parallel()
    return rank // mp, world // mp


def model_group() -> tuple[int, int]:
    """(tensor-parallel rank, tensor-parallel size): which slice of the
    heads and hidden units this rank holds, of how many. (0, 1) without a
    process group or at ``model_parallel`` 1."""
    rank, _ = process_group()
    mp = model_parallel()
    return rank % mp, mp
