"""Binary classification losses of occlusion masks (port of
``ocflow_tpu/losses/classification.py``: ``binary_cross_entropy``,
``focal_bce_loss``)."""

from __future__ import annotations

import torch


def binary_cross_entropy(pred: torch.Tensor, target: torch.Tensor,
                         eps: float = 1e-7) -> torch.Tensor:
    """Elementwise-mean BCE over probabilities clipped to ``[eps, 1 -
    eps]``."""
    p = pred.clamp(eps, 1.0 - eps)
    return (-(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))).mean()


def focal_bce_loss(pred: torch.Tensor, target: torch.Tensor, gamma: float = 2.0,
                   eps: float = 1e-7) -> torch.Tensor:
    """Focal BCE ``(1 - exp(-bce))^gamma * bce`` averaged, the per-element
    BCE over probabilities clipped to ``[eps, 1 - eps]``."""
    p = pred.clamp(eps, 1.0 - eps)
    bce = -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))
    return ((1.0 - torch.exp(-bce)) ** gamma * bce).mean()
