"""Photometric losses (port of ``ocflow_tpu/losses/photometric.py``), NCHW.

Elementwise terms run in the input dtype (bf16 under mixed precision);
every reduction accumulates in fp32: a bf16 sum over ~10M pixels loses the
loss signal (8-bit mantissa).

Both losses are ratios of batch-wide sums. Under data parallelism
(``reduce``: a function that sums a tensor over the ranks, without
gradient) each returns this rank's share of the global-batch value: its
own numerator over the global denominator. The shares sum to the loss of
the global batch, and so do their gradients.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def robust_l1(x: torch.Tensor, alpha: float = 0.001) -> torch.Tensor:
    """Charbonnier penalty ``sqrt(x^2 + alpha^2)``."""
    return torch.sqrt(x ** 2 + alpha ** 2)


def census_transform(img: torch.Tensor, patch_size: int = 7) -> torch.Tensor:
    """Soft census transform of ``[B, 3, H, W]`` images in [-1, 1]: each
    pixel's ``patch_size^2`` neighbourhood (zero padded, row-major taps) of
    grey values in [0, 255] minus the centre, as ``d / sqrt(0.81 + d^2)``.
    Returns ``[B, patch_size^2, H, W]``."""
    gray = ((img + 1.0) * 127.5).mean(1, keepdim=True)
    b, _, h, w = gray.shape
    p = patch_size
    patches = F.unfold(gray, p, padding=p // 2).reshape(b, p * p, h, w)
    diff = patches - gray
    return diff / torch.sqrt(0.81 + diff ** 2)


def census_loss(img1: torch.Tensor, img2_warped: torch.Tensor,
                occ: torch.Tensor | None = None,
                patch_size: int = 7, reduce=None) -> torch.Tensor:
    """Soft-hamming census distance, occlusion-masked (``occ`` ``[B, 1, H,
    W]``, 1 = occluded) and zero in the patch border. Without ``occ`` the
    denominator is one image's border mask (no batch axis), the same on
    every rank; ``reduce``: the module docstring."""
    t1 = census_transform(img1, patch_size)
    t2 = census_transform(img2_warped, patch_size)
    sq = (t1 - t2) ** 2
    ham = (sq / (0.1 + sq)).sum(1, keepdim=True)
    _, _, h, w = img1.shape
    pad = patch_size // 2
    mask = torch.zeros((1, 1, h, w), dtype=img1.dtype, device=img1.device)
    mask[:, :, pad:h - pad, pad:w - pad] = 1.0
    if occ is not None:
        mask = mask * (1.0 - occ)
    num = (robust_l1(ham) * mask).float().sum()
    den = mask.float().sum()
    if reduce is not None and occ is not None:
        den = reduce(den)
    return num / (den + 1e-16)


def photometric_error(img_pred: torch.Tensor, img: torch.Tensor,
                      occ: torch.Tensor | None = None, reduce=None) -> torch.Tensor:
    """Occlusion-normalized charbonnier photometric error of ``[B, 3, H,
    W]`` images. With ``occ`` (``[B, 1, H, W]``, 1 = occluded):
    ``sum(err * (1 - occ)) / (sum(1 - occ) * 3 + 1e-16)``; without, the
    mean. ``reduce``: the module docstring."""
    error = robust_l1(img_pred - img).float()
    if occ is None:
        if reduce is None:
            return error.mean()
        return error.sum() / reduce(error.new_tensor(float(error.numel())))
    vis = (1.0 - occ).float()
    den = vis.sum()
    if reduce is not None:
        den = reduce(den)
    return (error * vis).sum() / (den * 3.0 + 1e-16)
