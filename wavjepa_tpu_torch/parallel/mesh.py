"""Data parallelism over torch.distributed.

Counterpart of the data-parallel half of ``wavjepa_tpu/parallel/mesh.py``.
The JAX package runs one program over a device mesh whose batch axis is
sharded, and XLA inserts the gradient all-reduce. Here each rank is a
process with a card of its own (NCCL; gloo on the CPU) that holds its rows
of the global batch: the train steps draw their random crops and masks for
the global batch, take their rows (``shard_batch``), and sum the gradients
over the ranks once a step (``all_reduce_gradients``), so a step at any
world size is the step of one process on the whole batch.

    torchrun --standalone --nproc_per_node=8 -m wavjepa_tpu_torch.train ...

Tensor parallelism (the JAX package's ``param_sharding_rules``,
``shard_params`` and ``shard_train_state``) has no port yet.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

import torch
import torch.distributed as dist

from wavjepa_tpu_torch.data.pipeline import process_group

# gradients go over the wire in flat buckets of about this size
BUCKET_BYTES = 32 * 2**20


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: "str | torch.device" = "cpu",
) -> torch.device:
    """Join the run's process group and return this rank's device.

    Under torchrun (``WORLD_SIZE`` in the environment) the group starts from
    ``env://``; given ``coordinator_address`` ("host:port") and more than one
    process, from ``tcp://``. The backend is NCCL for a cuda ``device`` and
    gloo for the CPU. A cuda ``device`` without an index becomes
    ``cuda:LOCAL_RANK`` where torchrun set it, made current before anything
    is allocated. A process that joins no group (neither case) trains alone;
    a group that exists already (one the caller made) is used as it is. A
    failed start raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    if coordinator_address is not None and (num_processes or 1) > 1:
        init = dict(init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                    rank=process_id)
    elif "WORLD_SIZE" in os.environ:
        init = dict(init_method="env://")
    else:
        return dev
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", **init)
    return dev


def shard_batch(global_batch):
    """This rank's rows ``[r·B/W, (r+1)·B/W)`` of a global batch: an array or
    tensor, or a dict of them. Raises where the world size does not divide
    the batch; the batch itself at world size 1."""
    if isinstance(global_batch, dict):
        return {k: shard_batch(v) for k, v in global_batch.items()}
    rank, world = process_group()
    if world == 1:
        return global_batch
    b = global_batch.shape[0]
    if b % world:
        raise ValueError(f"a batch of {b} rows does not split over {world} ranks")
    n = b // world
    return global_batch[rank * n:(rank + 1) * n]


def replicated(module: torch.nn.Module) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` broadcast in place from rank
    0, so that no rank trains from weights of its own; ``module`` unchanged
    without a process group."""
    if dist.is_initialized():
        for t in module.state_dict().values():
            dist.broadcast(t, 0)
    return module


def _buckets(tensors: list, limit: int) -> Iterable[list]:
    """Consecutive runs of ``tensors`` of one dtype, each of at most
    ``limit`` bytes unless a single tensor is larger."""
    bucket, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (size + nbytes > limit or t.dtype != bucket[0].dtype):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        yield bucket


def all_reduce_gradients(params: list, *scalars: torch.Tensor) -> tuple:
    """Sum each parameter's gradient over the ranks, in place (a parameter
    without one gets zeros first, as the optimizer would give it), in flat
    buckets of about ``BUCKET_BYTES``: one round of ``all_reduce`` a step,
    after the last microbatch. ``scalars`` (a step's loss terms) go over the
    wire with them; returns them summed, as 0-d f32 tensors."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    tensors = [p.grad for p in params]
    if scalars:
        tensors.append(torch.stack([s.detach().float().reshape(()) for s in scalars]))
    for bucket in _buckets(tensors, BUCKET_BYTES):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat)
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(part.view_as(t))
    return tuple(tensors[-1].unbind()) if scalars else ()


def barrier() -> None:
    """Wait for every rank (after rank 0 writes a file the others read); a
    no-op without a process group."""
    if dist.is_initialized():
        dist.barrier()
