"""Straight-through estimator (port of ``ocflow_tpu/ops/ste.py``)."""

from __future__ import annotations

import torch


def hard_threshold_ste(soft: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """Binarize in the forward pass (1 where ``soft > threshold``, else 0:
    an input exactly at the threshold maps to 0), identity gradient in the
    backward pass: ``(hard - soft).detach() + soft``."""
    hard = (soft > threshold).to(soft.dtype)
    return (hard - soft).detach() + soft
