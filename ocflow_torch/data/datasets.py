"""Procedural datasets (port of ``ocflow_tpu/data/datasets.py``'s
``Dataset``, ``SyntheticFlow`` and ``SyntheticFlowWarp``).

A sample is a dict of NHWC tensors on the dataset's device: ``images``
[H, W, 6] (frames 1 | 2 on channels, in [-1, 1]), ``flow`` [H, W, 2] and,
with ``with_occ``, ``occ`` [H, W, 1]. The random draws are the JAX
package's numpy calls in the same order, from
``np.random.default_rng((seed, index % size))``, so a sample equals its
counterpart up to rounding; the Gaussian blur and the bilinear remap (OpenCV
there) are torch code on the device (:func:`gaussian_blur`,
:func:`remap_bilinear`).

The file-backed datasets and ``SyntheticInpainting`` are not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ocflow_torch import full_fp32_convs, resolve_device


def _reflect101(n: int, pad: int, device) -> torch.Tensor:
    """Indices ``-pad .. n-1+pad`` folded into ``[0, n)`` by reflect-101
    (``dcb|abcd|cba``), for any ``pad``: the border repeats with period
    ``2(n-1)``. ``F.pad(mode='reflect')`` refuses pads of ``n`` or more."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = i.remainder(period)
    return torch.where(i >= n, period - i, i)


def _gaussian_kernel(sigma: float, device) -> torch.Tensor:
    """OpenCV's Gaussian for a float image with ``ksize=(0, 0)``: size
    ``round(8 sigma + 1) | 1``, weights normalized to sum 1, fp32."""
    k = int(math.floor(sigma * 8 + 1 + 0.5)) | 1
    x = torch.arange(k, dtype=torch.float64) - (k - 1) / 2
    g = torch.exp(-x * x / (2 * sigma * sigma))
    return (g / g.sum()).to(device=device, dtype=torch.float32)


def gaussian_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """``cv2.GaussianBlur(x, (0, 0), sigma)`` of an fp32 ``[H, W]`` or
    ``[H, W, C]`` tensor: separable, reflect-101 borders, fp32 sums (no
    TF32)."""
    kern = _gaussian_kernel(sigma, x.device)
    r = kern.numel() // 2
    h, w = x.shape[:2]
    planes = (x[None] if x.dim() == 2 else x.permute(2, 0, 1)).float()
    with full_fp32_convs(torch.float32):
        # rows: [C*H, 1, W + 2r] -> [C*H, 1, W]
        y = planes.index_select(2, _reflect101(w, r, x.device))
        y = F.conv1d(y.reshape(-1, 1, w + 2 * r), kern.view(1, 1, -1)).view(-1, h, w)
        # columns, on the transposed planes
        y = y.transpose(1, 2).index_select(2, _reflect101(h, r, x.device))
        y = F.conv1d(y.reshape(-1, 1, h + 2 * r), kern.view(1, 1, -1)).view(-1, w, h)
    y = y.transpose(1, 2)
    return y[0].contiguous() if x.dim() == 2 else y.permute(1, 2, 0).contiguous()


def remap_bilinear(img: torch.Tensor, map_x: torch.Tensor,
                   map_y: torch.Tensor) -> torch.Tensor:
    """``cv2.remap(img, map_x, map_y, INTER_LINEAR, BORDER_REPLICATE)`` of
    an fp32 ``[H, W, C]`` image at fp32 ``[H', W']`` coordinates: bilinear
    over the four neighbours, each index clamped into the image."""
    h, w, c = img.shape
    x0f, y0f = torch.floor(map_x), torch.floor(map_y)
    fx, fy = map_x - x0f, map_y - y0f
    x0, y0 = x0f.long(), y0f.long()
    flat = img.reshape(h * w, c)

    def tap(yi, xi):
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        return flat.index_select(0, idx.reshape(-1)).view(*map_x.shape, c)

    fx, fy = fx[..., None], fy[..., None]
    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bottom = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bottom * fy


class Dataset:
    """Minimal map-style dataset protocol."""

    size: int
    replicates: int = 1

    def __len__(self):
        return self.size * self.replicates

    def __getitem__(self, index: int) -> dict:
        raise NotImplementedError


def _uniform(rng: np.random.Generator, shape, device) -> torch.Tensor:
    """``rng.uniform(-1, 1, shape).astype(np.float32)`` on ``device``."""
    return torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)).to(device)


class SyntheticFlow(Dataset):
    """Procedural pairs with known flow: frame 2 is frame 1 translated by a
    random integer shift (``ocflow_tpu`` ``SyntheticFlow``)."""

    def __init__(self, size=64, image_size=(64, 128), max_shift=4, seed=0,
                 with_occ=True, device=None):
        self.size = size
        self.image_size = image_size
        self.max_shift = max_shift
        self.seed = seed
        self.with_occ = with_occ
        self.device = resolve_device(device)

    def __getitem__(self, index):
        rng = np.random.default_rng((self.seed, index % self.size))
        h, w = self.image_size
        sx = int(rng.integers(-self.max_shift, self.max_shift + 1))
        sy = int(rng.integers(-self.max_shift, self.max_shift + 1))
        pad = self.max_shift
        base = _uniform(rng, (h + 2 * pad, w + 2 * pad, 3), self.device)
        base = (gaussian_blur(base, 3.0) * 3.0).clamp(-1.0, 1.0)
        img1 = base[pad:pad + h, pad:pad + w]
        img2 = base[pad + sy:pad + sy + h, pad + sx:pad + sx + w]
        # img2[y, x] = img1[y + sy, x + sx]: the flow is (-sx, -sy)
        flow = torch.empty((h, w, 2), device=self.device)
        flow[..., 0], flow[..., 1] = -sx, -sy
        sample = {"images": torch.cat([img1, img2], -1), "flow": flow}
        if self.with_occ:
            sample["occ"] = torch.zeros((h, w, 1), device=self.device)
        return sample


class SyntheticFlowWarp(Dataset):
    """Procedural pairs with a smooth non-rigid flow (``ocflow_tpu``
    ``SyntheticFlowWarp``): a multi-octave texture for frame 2, a random
    affine motion plus a band-limited random deformation for the flow F,
    and frame 1 inverse-warped through it, img1(p) = img2(p + F(p)) (the
    relation the backward warp assumes), border replicate outside the view.

    Arithmetic follows the JAX package's numpy: the texture and the blurred
    fields in fp32, the flow's affine part in float64 (numpy promotes the
    float64 translation draw), the flow and the sampling map cast to fp32.
    """

    def __init__(self, size=512, image_size=(448, 1024), max_shift=16.0,
                 seed=0, with_occ=False, device=None):
        self.size = size
        self.image_size = image_size
        self.max_shift = float(max_shift)
        self.seed = seed
        self.with_occ = with_occ
        self.device = resolve_device(device)

    def __len__(self):
        return self.size

    def __getitem__(self, index):
        rng = np.random.default_rng((self.seed, index % self.size))
        h, w = self.image_size
        dev = self.device

        # multi-octave texture in [-1, 1]
        img2 = torch.zeros((h, w, 3), device=dev)
        for sigma, amp in ((2.0, 1.0), (6.0, 1.5), (18.0, 2.0)):
            img2 += gaussian_blur(_uniform(rng, (h, w, 3), dev), sigma) * amp * sigma
        img2 = (img2 / img2.abs().max() * 1.6).clamp(-1.0, 1.0)

        # flow = affine (translation + small rotation / zoom) + smooth field
        yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                                torch.arange(w, dtype=torch.float32, device=dev),
                                indexing="ij")
        cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
        tx, ty = rng.uniform(-self.max_shift, self.max_shift, 2)
        rot = rng.uniform(-0.02, 0.02)
        zoom = rng.uniform(-0.02, 0.02)
        u = float(tx) + (zoom * (xx - cx)).double() - (rot * (yy - cy)).double()
        v = float(ty) + (zoom * (yy - cy)).double() + (rot * (xx - cx)).double()
        for sigma, amp in ((24.0, 4.0), (64.0, 8.0)):
            u += (gaussian_blur(_uniform(rng, (h, w), dev), sigma) * amp * sigma / 8.0).double()
            v += (gaussian_blur(_uniform(rng, (h, w), dev), sigma) * amp * sigma / 8.0).double()

        img1 = remap_bilinear(img2, (xx.double() + u).float(), (yy.double() + v).float())
        sample = {"images": torch.cat([img1, img2], -1),
                  "flow": torch.stack([u, v], -1).float()}
        if self.with_occ:
            sample["occ"] = torch.zeros((h, w, 1), device=dev)
        return sample


# the datasets ported so far (the JAX package's DATASET_REGISTRY has the
# file-backed ones and SyntheticInpainting too)
DATASET_REGISTRY = {
    "SyntheticFlow": SyntheticFlow,
    "SyntheticFlowWarp": SyntheticFlowWarp,
}
