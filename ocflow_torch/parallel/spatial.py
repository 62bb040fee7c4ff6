"""Height-sharded ops with a halo exchange (port of
``ocflow_tpu/parallel/spatial.py``), NCHW.

An image (or feature map) of ``H`` rows is split over the ranks of a
``Mesh`` into blocks of ``h = H / N`` rows, rank ``r`` holding rows ``[r h,
(r + 1) h)``. An op whose output row reads rows around it (the cost
volume's +-d window, the warp's vertical flow) first takes ``halo`` rows
from each neighbour (:func:`halo_exchange`, zeros past the image's first
and last rows, as the single-device ops pad), then computes its own rows.

``spatial_cost_volume`` runs the cost-volume kernels
(``kernels.cost_volume``: forward, and its backward under autograd)
unchanged on every rank; ``spatial_warp`` samples with ``ops.warp``'s
bilinear sampler.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ocflow_torch.kernels import cost_volume as cv_kernels
from ocflow_torch.ops.warp import mesh_grid, sample_bilinear
from ocflow_torch.parallel.mesh import Mesh


class _HaloExchange(torch.autograd.Function):
    """Rows ``[0, halo)`` go to rank - 1 and rows ``[h - halo, h)`` to rank
    + 1. The adjoint sends each halo's gradient back to the rank that owns
    those rows, which adds it to theirs."""

    @staticmethod
    def forward(ctx, x, halo, mesh):
        ctx.halo, ctx.mesh = halo, mesh
        from_prev, from_next = mesh.exchange(x[:, :, :halo], x[:, :, -halo:])
        return torch.cat([from_prev, x, from_next], 2)

    @staticmethod
    def backward(ctx, g):
        halo, mesh = ctx.halo, ctx.mesh
        from_prev, from_next = mesh.exchange(g[:, :, :halo], g[:, :, -halo:])
        gx = g[:, :, halo:-halo].clone()
        gx[:, :, :halo] += from_prev
        gx[:, :, -halo:] += from_next
        return gx, None, None


def halo_exchange(x: torch.Tensor, halo: int, mesh: Mesh) -> torch.Tensor:
    """``x [B, C, h, W]`` (this rank's rows) -> ``[B, C, h + 2 halo, W]``:
    rank - 1's last ``halo`` rows above, rank + 1's first below, zeros at
    the ends of the axis. Differentiable; ``halo`` must be at least 1 and at
    most ``h``."""
    h = x.shape[2]
    if not 1 <= halo <= h:
        raise ValueError(f"halo_exchange: a halo of {halo} rows around a block of {h}")
    return _HaloExchange.apply(x.contiguous(), halo, mesh)


def spatial_cost_volume(f1: torch.Tensor, f2: torch.Tensor, max_displacement: int,
                        mesh: Mesh) -> torch.Tensor:
    """The cost volume of H-sharded features: this rank's ``[B, C, h, W]``
    blocks of ``f1`` and ``f2`` -> its rows ``[B, (2d+1)^2, h, W]`` of the
    single-device ``kernels.cost_volume(f1, f2, d)``.

    ``f1``'s block, padded with d zero rows above and below, and ``f2``'s
    block with its halo of d rows, both ``[B, C, h + 2d, W]``, go through
    the kernel; rows ``[d, d + h)`` are kept: each reads the same ``f1``
    and ``f2`` values as the single-device op. Under autograd the gradient
    runs through the backward kernel, the slice, the pad and the halo's
    adjoint."""
    d = max_displacement
    h = f1.shape[2]
    f2h = halo_exchange(f2, d, mesh)
    f1p = F.pad(f1, (0, 0, d, d))
    return cv_kernels.cost_volume(f1p, f2h, d)[:, :, d:d + h]


def spatial_warp(img: torch.Tensor, flow: torch.Tensor, max_flow: int, mesh: Mesh,
                 align_corners: bool = True) -> torch.Tensor:
    """Backward warp of H-sharded ``img [B, C, h, W]`` by this rank's
    ``flow [B, 2, h, W]`` rows; equal to ``ops.warp`` on the whole image
    while ``|v| <= max_flow``. The image block takes a halo of ``max_flow +
    1`` rows; the coordinates, the taps and their weights are the whole
    image's (rows counted from its first), read from the haloed block."""
    halo = max_flow + 1
    imgh = halo_exchange(img, halo, mesh)
    _, _, hs, w = flow.shape
    flow = flow.float()
    start = mesh.rank * hs
    xx, yy = mesh_grid(hs, w, dtype=torch.float32, device=flow.device)
    x = xx[None] + flow[:, 0]
    y = (yy[None] + start) + flow[:, 1]
    rows = hs * mesh.size
    if not align_corners:
        sx, sy = (float(torch.tensor(n / max(n - 1, 1), dtype=torch.float32))
                  for n in (w, rows))
        x = (x.double() * sx - 0.5).float()
        y = (y.double() * sy - 0.5).float()
    return sample_bilinear(imgh, x, y, row0=start - halo, rows=rows)
