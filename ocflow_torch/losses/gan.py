"""SN-PatchGAN hinge losses (port of ``ocflow_tpu/losses/gan.py``), on the
discriminator's outputs of any shape."""

from __future__ import annotations

import torch


def sn_dis_loss(pos: torch.Tensor, neg: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """Hinge discriminator loss ``mean(relu(1 - pos)) + mean(relu(1 + neg))``."""
    return weight * (torch.relu(1.0 - pos).mean() + torch.relu(1.0 + neg).mean())


def sn_gen_loss(neg: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """Hinge generator loss ``-mean(neg)``."""
    return -weight * neg.mean()
