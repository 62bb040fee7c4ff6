"""Bilinear backward warping with zero padding (``F.grid_sample`` semantics).

Port of ``ocflow_tpu/ops/warp.py`` in NCHW: ``img [B, C, H, W]``, ``flow
[B, 2, H, W]`` with channel 0 = u (x displacement), 1 = v (y).

Coordinates and bilinear hat weights are ALWAYS fp32: a bf16 coordinate
grid quantizes sample positions (1 px spacing past x = 256). The four taps
are gathered by hand and summed in fp32 (fp64 for an fp64 image), so the
sampled tensor keeps its own dtype.
"""

from __future__ import annotations

import torch


def mesh_grid(height: int, width: int, dtype=torch.float32, device=None):
    """Pixel-coordinate mesh grid ``(xx, yy)``, each ``[H, W]``."""
    yy, xx = torch.meshgrid(
        torch.arange(height, dtype=dtype, device=device),
        torch.arange(width, dtype=dtype, device=device),
        indexing="ij")
    return xx, yy


def flow_to_warp(flow: torch.Tensor) -> torch.Tensor:
    """Sampling coordinates ``grid + flow`` of a ``[B, 2, H, W]`` flow."""
    _, _, h, w = flow.shape
    xx, yy = mesh_grid(h, w, dtype=flow.dtype, device=flow.device)
    return torch.stack([xx, yy])[None] + flow


def warp(img: torch.Tensor, flow: torch.Tensor,
         align_corners: bool = True) -> torch.Tensor:
    """Backward-warp ``img`` by ``flow``.

    ``align_corners=True`` samples at ``grid + flow`` exactly; ``False``
    rescales by ``W / (W - 1)`` and shifts by -0.5 (the grid_sample
    align_corners=False mapping of coordinates normalized by (W-1, H-1)),
    rounded to fp32 once, as the reference's jitted warp rounds its fused
    multiply-add: the product of two fp32 values is exact in fp64.
    Taps outside the image get weight 0. Returns ``img``'s dtype.
    """
    coords = flow_to_warp(flow.float())
    x, y = coords[:, 0], coords[:, 1]
    if not align_corners:
        _, _, h, w = img.shape
        sx, sy = (float(torch.tensor(n / max(n - 1, 1), dtype=torch.float32))
                  for n in (w, h))
        x = (x.double() * sx - 0.5).float()
        y = (y.double() * sy - 0.5).float()
    return sample_bilinear(img, x, y)


def sample_bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    row0: int = 0, rows: int | None = None) -> torch.Tensor:
    """``img [B, C, Hi, Wi]`` sampled bilinearly at the fp32 pixel
    coordinates ``x``, ``y`` (``[B, Ho, Wo]``); taps outside the image get
    weight 0. ``y`` may count rows in a taller frame of ``rows`` rows whose
    row ``row0`` is ``img``'s first (a block of an image's rows): the taps
    and weights are those of the whole frame, read from ``img``. Returns
    ``[B, C, Ho, Wo]`` in ``img``'s dtype."""
    b, c, h, w = img.shape
    n = x.shape[1] * x.shape[2]
    x0 = torch.floor(x).clamp(0, w - 2)
    y0 = torch.floor(y).clamp(0, (h if rows is None else rows) - 2)
    acc = torch.promote_types(img.dtype, torch.float32)
    wx = [torch.relu(1.0 - (x - (x0 + k)).abs()).to(acc) for k in (0, 1)]
    wy = [torch.relu(1.0 - (y - (y0 + k)).abs()).to(acc) for k in (0, 1)]
    base = ((y0.long() - row0).clamp(0, h - 2) * w + x0.long()).reshape(b, 1, n)
    flat = img.reshape(b, c, h * w)
    out = torch.zeros((b, c, n), dtype=acc, device=img.device)
    for dy in (0, 1):
        for dx in (0, 1):
            idx = (base + (dy * w + dx)).expand(b, c, n)
            wgt = (wy[dy] * wx[dx]).reshape(b, 1, n)
            out += torch.gather(flat, 2, idx).to(acc) * wgt
    return out.reshape(b, c, *x.shape[1:]).to(img.dtype)
