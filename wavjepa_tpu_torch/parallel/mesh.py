"""Data and tensor parallelism over torch.distributed.

Counterpart of ``wavjepa_tpu/parallel/mesh.py``. The JAX package runs one
program over a (data, model) device mesh, and XLA inserts the collectives.
Here each rank is a process with a card of its own (NCCL; gloo on the CPU).

Data parallelism: a rank holds its rows of the global batch. The train
steps draw their random crops and masks for the global batch, take their
rows (``shard_batch``), and sum the gradients over the data-parallel ranks
once a step (``all_reduce_gradients``), so a step at any world size is the
step of one process on the whole batch.

Tensor parallelism (``trainer.model_parallel = mp``): ``init_layout`` puts
rank ``r`` at data ``r // mp`` and model ``r % mp``, as ``make_mesh``'s
reshape places device ``r``, and makes one tensor-parallel group and one
data-parallel group a rank. The transformer blocks are split Megatron-style
as ``_tp_rule`` splits them (``tp_rule``): the QKV projection and
``linear1`` by output features, ``out_proj`` and ``linear2`` by input
features, everything else replicated. The JAX rule cuts the packed QKV
outputs into contiguous halves, GSPMD storage that XLA re-lays for compute;
the port cuts them per head (a rank holds the q, k and v rows of its own
heads), so that attention stays local to a rank. The function computed is
the same. ``ops/transformer.py`` carries the two collectives of a block.

    torchrun --standalone --nproc_per_node=8 -m wavjepa_tpu_torch.train ...
    torchrun --standalone --nproc_per_node=2 -m wavjepa_tpu_torch.train \
        configs/large.yaml trainer.model_parallel=2
"""

from __future__ import annotations

import os
from typing import Iterable, Optional, Sequence

import torch
import torch.distributed as dist

from wavjepa_tpu_torch.parallel.layout import (  # noqa: F401 (the layout's queries)
    data_group,
    data_world,
    model_group,
    process_group,
    set_model_parallel,
)

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


# ------------------------------------------------------------- the layout

_GROUPS: dict = {}  # (world, mp) → (this rank's data group, its model group)


def init_layout(model_parallel: int = 1) -> None:
    """Lay the ranks out as (data, model) with ``model_parallel`` ranks to a
    tensor-parallel group: rank r at data r // mp, model r % mp. Every rank
    makes every group, in one order (``dist.new_group`` asks it of every
    rank), once for a (world, mp). Raises where ``model_parallel`` does not
    divide the world (``data_world``). Without a process group only mp = 1
    is taken."""
    mp = int(model_parallel)
    _, world = process_group()
    data_world(world, mp)
    set_model_parallel(mp)
    if mp == 1 or (world, mp) in _GROUPS:
        return
    rank = dist.get_rank()
    data, model = None, None
    for d in range(world // mp):
        g = dist.new_group([d * mp + t for t in range(mp)])
        model = g if rank // mp == d else model
    for t in range(mp):
        g = dist.new_group([d * mp + t for d in range(world // mp)])
        data = g if rank % mp == t else data
    _GROUPS[(world, mp)] = (data, model)


def _groups() -> tuple:
    _, world = process_group()
    return _GROUPS.get((world, model_group()[1]), (None, None))


def data_process_group():
    """This rank's data-parallel group (None: the whole world, at mp 1)."""
    return _groups()[0]


def model_process_group():
    """This rank's tensor-parallel group (None at mp 1)."""
    return _groups()[1]


# -------------------------------------------------------------- the split

PER_HEAD = "self_attn.in_proj_"  # q | k | v rows, each head-major: cut per head


def tp_rule(name: str) -> Optional[int]:
    """The dim of a state-dict leaf that tensor parallelism splits, or None
    (replicated): ``_tp_rule`` on the port's names (``api/convert.py``),
    whose weights are (out, in) where the JAX kernels are (in, out). Rows:
    ``self_attn.in_proj_weight`` and ``in_proj_bias`` (per head, see
    ``shard_tensor``), ``linear1.weight`` and ``linear1.bias``. Columns:
    ``self_attn.out_proj.weight`` and ``linear2.weight``. Everything else,
    ``out_proj.bias`` and ``linear2.bias`` among it, is replicated."""
    if name.endswith(("self_attn.in_proj_weight", "self_attn.in_proj_bias",
                      "linear1.weight", "linear1.bias")):
        return 0
    if name.endswith(("self_attn.out_proj.weight", "linear2.weight")):
        return 1
    return None


def shard_tensor(name: str, full: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    """Tensor-parallel rank ``rank``'s slice of the full leaf ``name`` (a
    copy), of ``size``: contiguous rows or columns by ``tp_rule``, and for
    the packed QKV the q, k and v rows of the rank's heads, each block cut
    alike. The leaf itself where it is replicated or ``size`` is 1."""
    dim = tp_rule(name)
    if dim is None or size == 1:
        return full
    if full.shape[dim] % (3 * size if PER_HEAD in name else size):
        raise ValueError(f"{name} {tuple(full.shape)} does not split over {size} ranks")
    if PER_HEAD in name:
        return full.reshape(3, size, -1, *full.shape[1:])[:, rank].reshape(
            -1, *full.shape[1:]).clone()
    return full.chunk(size, dim=dim)[rank].clone()


def join_shards(name: str, shards: Sequence[torch.Tensor]) -> torch.Tensor:
    """The full leaf from every rank's ``shard_tensor``, in rank order."""
    dim = tp_rule(name)
    if dim is None or len(shards) == 1:
        return shards[0]
    if PER_HEAD in name:
        rest = shards[0].shape[1:]
        return torch.stack([s.reshape(3, -1, *rest) for s in shards], dim=1).reshape(-1, *rest)
    return torch.cat(list(shards), dim=dim)


def shard_params(state_dict: dict, tp: Optional[tuple] = None) -> dict:
    """A full state dict (student, ``teacher_encoder.*``) cut to a
    tensor-parallel rank's shard: ``tp`` (rank, size), this rank's
    ``model_group()`` by default."""
    rank, size = model_group() if tp is None else tp
    return {k: shard_tensor(k, v, rank, size) for k, v in state_dict.items()}


def gather_tensor(name: str, shard: torch.Tensor) -> torch.Tensor:
    """The full leaf ``name`` from every tensor-parallel rank's shard (an
    all-gather over the group, in which every rank of it takes part); the
    shard itself where the leaf is replicated or at mp 1."""
    _, size = model_group()
    if size == 1 or tp_rule(name) is None:
        return shard
    parts = [torch.empty_like(shard) for _ in range(size)]
    dist.all_gather(parts, shard.contiguous(), group=model_process_group())
    return join_shards(name, parts)


def gather_params(state_dict: dict) -> dict:
    """This rank's shard of a state dict → the full one (``gather_tensor``
    leaf by leaf, in the dict's order, which is every rank's)."""
    return {k: gather_tensor(k, v) for k, v in state_dict.items()}


_MOMENTS = ("exp_avg", "exp_avg_sq")  # AdamW's per-parameter state


def _optimizer_leaves(opt_state: dict, names: Sequence[str], fn) -> dict:
    state = {}
    for i, per in opt_state["state"].items():
        state[i] = {k: fn(names[int(i)], v) if k in _MOMENTS else v for k, v in per.items()}
    return {"state": state, "param_groups": opt_state["param_groups"]}


def shard_train_state(weights: dict, opt_state: dict,
                      names: Sequence[str]) -> tuple[dict, dict]:
    """A whole train state cut to this rank's shard: the weights (student
    and teacher, ``shard_params``) and the AdamW moments of ``opt_state`` (a
    torch optimizer ``state_dict`` whose parameter i is ``names[i]``) by
    the same rule; step counts stay as they are."""
    rank, size = model_group()
    return (shard_params(weights),
            _optimizer_leaves(opt_state, names, lambda n, v: shard_tensor(n, v, rank, size)))


def gather_train_state(weights: dict, opt_state: dict,
                       names: Sequence[str]) -> tuple[dict, dict]:
    """The inverse of ``shard_train_state``, over the tensor-parallel group
    (every rank takes part, and every one gets the whole)."""
    return gather_params(weights), _optimizer_leaves(opt_state, names, gather_tensor)


def sharded(full: torch.nn.Module, local: torch.nn.Module) -> torch.nn.Module:
    """``local`` (the same model built at the run's ``model_parallel``)
    given this rank's shard of ``full``'s weights."""
    local.load_state_dict(shard_params(full.state_dict()))
    return local


# ------------------------------------------------------------ the batches

def shard_batch(global_batch):
    """This data-parallel rank's rows ``[r·B/W, (r+1)·B/W)`` of a global
    batch: an array or tensor, or a dict of them. Every rank of one
    tensor-parallel group takes the same rows. Raises where the
    data-parallel world does not divide the batch; the batch itself at
    data-parallel world size 1."""
    if isinstance(global_batch, dict):
        return {k: shard_batch(v) for k, v in global_batch.items()}
    rank, world = data_group()
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


def all_reduce_gradients(params: list, *scalars: torch.Tensor, group=None) -> tuple:
    """Sum each parameter's gradient over the ranks of ``group`` (the
    world by default; the train steps pass ``data_process_group()``), in
    place (a parameter without one gets zeros first, as the optimizer would
    give it), in flat buckets of about ``BUCKET_BYTES``: one round of
    ``all_reduce`` a step, after the last microbatch. ``scalars`` (a step's
    loss terms) go over the wire with them; returns them summed, as 0-d f32
    tensors."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    tensors = [p.grad for p in params]
    if scalars:
        tensors.append(torch.stack([s.detach().float().reshape(()) for s in scalars]))
    for bucket in _buckets(tensors, BUCKET_BYTES):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(part.view_as(t))
    return tuple(tensors[-1].unbind()) if scalars else ()


def mean_over_model_group(tensors: list) -> None:
    """Each tensor replaced in place by its mean over this rank's
    tensor-parallel group, in flat buckets of about ``BUCKET_BYTES``; a
    no-op at mp 1. The train steps give it the replicated leaves'
    gradients: equal on every rank of the group in exact arithmetic, but
    the card's backward has atomics (a gather's scatter-add) whose order
    varies from run to run, so each rank's copy of a replicated weight
    would drift from the others' step by step."""
    _, size = model_group()
    if size == 1 or not tensors:
        return
    for bucket in _buckets(tensors, BUCKET_BYTES):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=model_process_group())
        flat.div_(size)
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(part.view_as(t))


def global_grad_norm(grads: list, split: Sequence[bool]) -> torch.Tensor:
    """The L2 norm of the whole model's gradient from this rank's shards:
    the squared norms of the split leaves (``split[i]``, by ``tp_rule``)
    summed over the tensor-parallel group, once, and those of the
    replicated leaves, whose gradients every rank of the group holds whole
    and equal, counted once. At mp 1, the norm of the leaves' norms."""
    norms = torch.stack(torch._foreach_norm(grads))
    if model_group()[1] == 1:
        return torch.linalg.vector_norm(norms)
    mask = torch.tensor(list(split), dtype=torch.bool, device=norms.device)
    sq = norms.square()
    split_sq = sq[mask].sum()
    dist.all_reduce(split_sq, group=model_process_group())
    return (split_sq + sq[~mask].sum()).sqrt()


def same_over_model_group(tree):
    """A tensor, or a nested dict of them, made the same on every rank of
    this rank's tensor-parallel group: broadcast in place from the group's
    first rank, leaf by leaf in the dict's order. Those ranks hold one
    replica of the model and must see the same batch; ``tree`` unchanged
    at mp 1 (and None stays None)."""
    rank, size = model_group()
    if size == 1 or tree is None:
        return tree
    if isinstance(tree, dict):
        return {k: same_over_model_group(v) for k, v in tree.items()}
    dist.broadcast(tree, process_group()[0] - rank, group=model_process_group())
    return tree


def from_rank_zero(obj):
    """Rank 0's ``obj`` (a picklable value) on every rank: a decision that
    reads the file system, taken once, so that no rank takes another
    (every rank must issue the same collectives). ``obj`` itself without a
    process group."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier() -> None:
    """Wait for every rank (after rank 0 writes a file the others read); a
    no-op without a process group."""
    if dist.is_initialized():
        dist.barrier()
