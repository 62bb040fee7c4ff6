"""Image quality metrics (port of ``ocflow_tpu/metrics/image_metrics.py``):
PSNR and windowed SSIM of NHWC images in [-1, 1], on their own device.

PSNR compares at the 255 scale, SSIM in [0, 1], as the reference's
evaluation denormalizes. SSIM's window is its 4x4 Gaussian (sigma 1.5), an
even size: padding 2 on each side gives an (H + 1) x (W + 1) map, the taps
sit at offsets -2..1, and the padding is zeros. Its depthwise convolutions
run in strict fp32 (``full_fp32_convs``: no TF32): E[x^2] - mu^2 cancels,
and a rounded product there made the JAX package's SSIM exceed 1 on real
evaluations.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ocflow_torch import full_fp32_convs


def psnr(img1: torch.Tensor, img2: torch.Tensor, pixel_max: float = 255.0) -> torch.Tensor:
    """PSNR of two images in [-1, 1] compared at the 255 scale: ``20
    log10(pixel_max / sqrt(mse))``, ``inf`` where the MSE is 0."""
    a, b = (img1 + 1.0) * 127.5, (img2 + 1.0) * 127.5
    mse = ((a - b) ** 2).mean()
    return torch.where(mse == 0, torch.full_like(mse, float("inf")),
                       20.0 * torch.log10(pixel_max / torch.sqrt(mse)))


@functools.lru_cache(maxsize=8)
def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 4,
         sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM of ``[B, H, W, C]`` images in [-1, 1] (compared in [0, 1])
    over the Gaussian window's map, per channel, zero padding
    ``window_size // 2``."""
    x = ((img1 + 1.0) / 2.0).permute(0, 3, 1, 2)
    y = ((img2 + 1.0) / 2.0).permute(0, 3, 1, 2)
    c = x.shape[1]
    w = torch.from_numpy(_gaussian_window(window_size, sigma)).to(x.device, x.dtype)
    kernel = w.expand(c, 1, window_size, window_size)
    pad = window_size // 2

    def conv(t):
        return F.conv2d(t, kernel, padding=pad, groups=c)

    with full_fp32_convs(torch.float32):
        mu1, mu2 = conv(x), conv(y)
        mu1_sq, mu2_sq, mu12 = mu1 ** 2, mu2 ** 2, mu1 * mu2
        sigma1 = conv(x * x) - mu1_sq
        sigma2 = conv(y * y) - mu2_sq
        sigma12 = conv(x * y) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1 + sigma2 + c2))
    return ssim_map.mean()


def completed_images(inpaint_fn, batches, device=None):
    """Per batch of ``{'image', 'occ'}``: ``(complete, image)`` with
    ``complete = recon * mask + image * (1 - mask)``, ``recon =
    inpaint_fn(image, mask)`` (the net zeroes the hole itself). With
    ``device``, each batch moves there only as it is reached, so host
    batches (``evaluate --task inpainting``) put one batch at a time on the
    card."""
    for batch in batches:
        imgs, masks = batch["image"], batch["occ"]
        if device is not None:
            imgs, masks = imgs.to(device), masks.to(device)
        recon = inpaint_fn(imgs, masks)
        yield recon * masks + imgs * (1 - masks), imgs


def calculate_psnr(inpaint_fn, batches, device=None) -> float:
    """The mean over batches of each batch's PSNR of the completed images
    (each batch on ``device``, ``completed_images``)."""
    return float(np.mean([float(psnr(c, i))
                          for c, i in completed_images(inpaint_fn, batches, device)]))


def calculate_ssim(inpaint_fn, batches, window_size: int = 4, device=None) -> float:
    """The mean over batches of each batch's SSIM of the completed images
    (each batch on ``device``, ``completed_images``)."""
    return float(np.mean([float(ssim(c, i, window_size=window_size))
                          for c, i in completed_images(inpaint_fn, batches, device)]))
