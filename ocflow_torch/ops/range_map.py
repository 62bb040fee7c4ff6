"""Forward-splat range map and occlusion masks (port of
``ocflow_tpu/ops/range_map.py``), NCHW: flows ``[B, 2, H, W]`` (channel 0 =
x displacement), masks ``[B, 1, H, W]`` with 1 = occluded.

``compute_range_map`` splats a bilinear unit of mass from every pixel's
flow endpoint onto its four neighbours with one ``index_add_`` on a flat
``[B * H * W]`` fp32 buffer (the JAX package's XLA scatter; plain PyTorch on
both devices, not a kernel). Coordinates and sums are fp32 whatever the
flow dtype: bf16 would quantize the targets and lose counts. Invalid taps
keep a (clipped) index and get weight 0; x is checked against the width, y
against the height. On CUDA ``index_add_`` adds with atomics, so fp32 sums
differ from run to run in the last bits.
"""

from __future__ import annotations

import torch

from ocflow_torch.ops.warp import flow_to_warp, mesh_grid, warp


def compute_range_map(flow: torch.Tensor) -> torch.Tensor:
    """Sum of the bilinear weights landing on each pixel, ``[B, 1, H, W]``
    fp32."""
    b, _, h, w = flow.shape
    coords = flow_to_warp(flow.float())
    floor = torch.floor(coords)
    offset = (coords - floor).reshape(b, 2, h * w)
    floor = floor.long().reshape(b, 2, h * w)
    base = torch.arange(b, device=flow.device).reshape(b, 1) * (h * w)
    counts = torch.zeros(b * h * w, dtype=torch.float32, device=flow.device)
    for di in (0, 1):
        for dj in (0, 1):
            ix = floor[:, 0] + di
            iy = floor[:, 1] + dj
            valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
            wx = (1.0 - di) - (-1.0) ** di * offset[:, 0]
            wy = (1.0 - dj) - (-1.0) ** dj * offset[:, 1]
            idx = base + iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
            counts.index_add_(0, idx.reshape(-1),
                              (wx * wy * valid.float()).reshape(-1))
    return counts.reshape(b, 1, h, w)


def occlusion_from_back_flow(back_flow: torch.Tensor) -> torch.Tensor:
    """Occlusion of frame 1 from the backward flow (2 -> 1): pixels the
    backward flow never references, ``1 - clip(range_map, 0, 1)``."""
    return 1.0 - compute_range_map(back_flow).clamp(0.0, 1.0)


def occlusion_fb_consistency(flow_fwd: torch.Tensor, flow_bwd: torch.Tensor,
                             alpha1: float = 0.01,
                             alpha2: float = 0.5) -> torch.Tensor:
    """Forward-backward consistency occlusion (UnFlow): occluded where
    ``|F_fwd(p) + F_bwd(p + F_fwd(p))|^2 > alpha1 * (|F_fwd|^2 + |F_bwd(.)|^2)
    + alpha2`` or where the forward endpoint leaves the frame. Gradient-free,
    fp32 coordinates; the backward flow is sampled with the zero-padded
    bilinear ``warp`` (``align_corners=True``)."""
    with torch.no_grad():
        flow_fwd = flow_fwd.float()
        flow_bwd = flow_bwd.float()
        _, _, h, w = flow_fwd.shape
        xx, yy = mesh_grid(h, w, device=flow_fwd.device)
        x = xx + flow_fwd[:, 0]
        y = yy + flow_fwd[:, 1]
        bwd_at = warp(flow_bwd, flow_fwd, align_corners=True)
        sq_diff = ((flow_fwd + bwd_at) ** 2).sum(1)
        sq_mag = (flow_fwd ** 2 + bwd_at ** 2).sum(1)
        inconsistent = sq_diff > alpha1 * sq_mag + alpha2
        out_of_frame = (x < 0) | (x > w - 1) | (y < 0) | (y > h - 1)
        return (inconsistent | out_of_frame)[:, None].float()
