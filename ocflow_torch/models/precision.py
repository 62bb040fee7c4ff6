"""Mixed-precision policy (port of ``ocflow_tpu/models/precision.py``):
the network body in bf16 over fp32 master parameters.

:func:`apply_mixed` runs a module on bf16 views of its floating parameters
(``torch.func.functional_call``; the cast is differentiable, so gradients
land in fp32 on the master weights) and of its floating inputs, and hands
its floating outputs back in fp32. Its BatchNorms (``models.common.
BatchNorm``) run flax's BatchNorm under the same policy as ``jax.jit``
compiles it (batch statistics in fp32, the running statistics cast on their
way in, the train-mode update ``bf16(0.9) * bf16(ra) + 0.1 * batch`` in
fp32 written back to the fp32 buffers). ``dtype=None`` is a pass-through.
Master parameters, optimizer state and the losses stay fp32.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from ocflow_torch.models.common import policy_stats


def cast_floating(tree: Any, dtype: torch.dtype) -> Any:
    """``tree`` (tensors in dicts, lists and tuples) with its floating
    tensors cast to ``dtype``; integer and boolean tensors, and anything
    else, as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    return tree


def resolve_dtype(name: Any) -> torch.dtype | None:
    """``'bfloat16'`` / ``'float32'`` / ``None`` / a ``torch.dtype`` -> the
    policy's dtype, ``None`` for fp32 (the pass-through)."""
    if name is None or name == "float32" or name == torch.float32:
        return None
    if isinstance(name, str):
        return getattr(torch, name)
    return name


def apply_mixed(model: nn.Module, *args, dtype: torch.dtype | None = torch.bfloat16, **kwargs):
    """``model(*args, **kwargs)`` under the policy of ``dtype``: its
    floating parameters and positional inputs cast to ``dtype``, its
    floating outputs cast back to fp32. The module's mode decides, as
    everywhere in the port: in train mode its BatchNorms normalize by the
    batch and keep their update of the running statistics (in the fp32
    buffers), as the JAX steps' ``mutable=['batch_stats']``; in eval mode
    they use the cast running statistics. ``dtype=None`` runs ``model`` as
    it is."""
    if dtype is None:
        return model(*args, **kwargs)
    params = {name: p.to(dtype) if p.is_floating_point() else p
              for name, p in model.named_parameters()}
    with policy_stats(model, dtype):
        out = torch.func.functional_call(model, params, cast_floating(args, dtype), kwargs)
    return cast_floating(out, torch.float32)
