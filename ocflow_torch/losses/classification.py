"""Binary classification loss of occlusion masks (port of
``ocflow_tpu/losses/classification.py``: ``binary_cross_entropy``)."""

from __future__ import annotations

import torch


def binary_cross_entropy(pred: torch.Tensor, target: torch.Tensor,
                         eps: float = 1e-7) -> torch.Tensor:
    """Elementwise-mean BCE over probabilities clipped to ``[eps, 1 -
    eps]``."""
    p = pred.clamp(eps, 1.0 - eps)
    return (-(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))).mean()
