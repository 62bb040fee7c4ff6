"""Inpainting reconstruction losses (port of
``ocflow_tpu/losses/reconstruction.py``). Elementwise and reduced over every
element, so any layout works whose mask broadcasts against the images
(``[B, H, W, C]`` with ``[B, H, W, 1]``, or ``[B, C, H, W]`` with ``[B, 1,
H, W]``); 1 = hole. ``reduce`` (data parallelism, as in
``losses.photometric``): a function that sums a tensor over the ranks,
without gradient; the ratio loss then returns this rank's share of the
global-batch value."""

from __future__ import annotations

import torch


def masked_l1_loss(img_completed: torch.Tensor, img: torch.Tensor,
                   occ: torch.Tensor, reduce=None) -> torch.Tensor:
    """Supervised inpainting loss, the L1 over the hole normalized by its
    area times 3 channels: ``sum(|Ic - I| occ) / (3 sum(occ) + 1e-16)``;
    ``reduce``: the module docstring."""
    den = occ.sum()
    if reduce is not None:
        den = reduce(den)
    return (img_completed - img).abs().mul(occ).sum() / (3.0 * den + 1e-16)


def _split_l1(imgs, out, masks, mask_mean):
    diff = (imgs - out).abs()
    return (diff * masks / mask_mean).mean(), (diff * (1.0 - masks) / (1.0 - mask_mean)).mean()


def recon_loss(imgs: torch.Tensor, recon_imgs: torch.Tensor, masks: torch.Tensor,
               coarse_imgs: torch.Tensor | None = None, rhole_alpha: float = 1.0,
               runhole_alpha: float = 1.0, chole_alpha: float = 1.0,
               cunhole_alpha: float = 1.0):
    """DeepFill-style L1 normalized by each image's mask: the hole term
    ``mean(|I - R| m / mean_i(m))`` and the un-hole term ``mean(|I - R| (1 -
    m) / (1 - mean_i(m)))``, ``mean_i`` over image i's mask; with
    ``coarse_imgs`` the same two terms of the coarse output join the total.
    Returns ``(total, rhole, runhole)``."""
    b = masks.shape[0]
    mask_mean = masks.reshape(b, -1).mean(1).reshape(b, *([1] * (masks.dim() - 1)))
    rhole, runhole = _split_l1(imgs, recon_imgs, masks, mask_mean)
    total = rhole_alpha * rhole + runhole_alpha * runhole
    if coarse_imgs is not None:
        chole, cunhole = _split_l1(imgs, coarse_imgs, masks, mask_mean)
        total = total + chole_alpha * chole + cunhole_alpha * cunhole
    return total, rhole, runhole
