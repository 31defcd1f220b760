"""Recomputation: the port's counterpart of flax's ``nn.remat`` with a
``save_only_these_names`` policy.

``remat(fn, *args)`` runs ``fn(*args)`` under
``torch.utils.checkpoint.checkpoint`` (non-reentrant): the forward keeps
``args`` and nothing that ``fn`` computes from them, and the backward runs
``fn`` again to get what its own backward needs. A region's output is what
the next region keeps, so a caller expresses a JAX policy by where it cuts
its regions: ``ops/transformer.py`` cuts a layer after ``self_attn``, so
that the layer input and ``attn_out`` are what stays, as
``save_only_these_names("attn_out")`` keeps them.

It does nothing, and costs nothing, where no gradient will be taken:
``torch.is_grad_enabled()`` false (``torch.no_grad``, ``inference_mode``:
serving, the EMA teacher, the frozen denoise teacher), or no tensor of
``args`` and no parameter of the module that ``fn`` is, or is a method of,
requiring one. The regions draw no random numbers, so the RNG state is not
saved and restored around the replay.

Modules are not wrapped (no ``checkpoint_wrapper``): the state-dict names
stay the reference's.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


def _needs_grad(fn: Callable, args: tuple) -> bool:
    if any(isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return True
    owner = fn if isinstance(fn, nn.Module) else getattr(fn, "__self__", None)
    return isinstance(owner, nn.Module) and any(p.requires_grad for p in owner.parameters())


def remat(fn: Callable, *args: Any) -> Any:
    """``fn(*args)``, replayed in the backward instead of keeping what it
    computes, where a gradient will be taken; else ``fn(*args)`` alone."""
    if not (torch.is_grad_enabled() and _needs_grad(fn, args)):
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
