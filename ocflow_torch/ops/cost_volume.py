"""Cost volume (local cross-correlation) and UFlow feature normalization.

Port of ``ocflow_tpu/ops/cost_volume.py`` in NCHW:

- ``cost_volume``: for every shift (i, j) in [0, 2d]^2, the per-pixel MEAN
  over channels of ``f1 * f2[y + i - d, x + j - d]`` with f2 zero-padded;
  output channel ``k = i * (2d + 1) + j`` (i indexes the height shift).
  This is the plain version; the Hopper kernel is
  ``ocflow_torch.kernels.cost_volume``.
- ``normalize_features``: centre and scale every tensor by moments that
  are collapsed across the batch AND across the list (biased variance,
  ``sqrt(var + eps)``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cost_volume(f1: torch.Tensor, f2: torch.Tensor,
                max_displacement: int = 4) -> torch.Tensor:
    """Correlation cost volume of ``[B, C, H, W]`` features.

    Accumulates in fp32 (fp64 for fp64 input) and returns ``[B, (2d+1)^2,
    H, W]`` in the input dtype.
    """
    b, c, h, w = f1.shape
    d = max_displacement
    n = 2 * d + 1
    acc = torch.promote_types(f1.dtype, torch.float32)
    a = f1.to(acc)
    f2p = F.pad(f2.to(acc), (d, d, d, d))
    out = torch.empty((b, n * n, h, w), dtype=acc, device=f1.device)
    for i in range(n):
        for j in range(n):
            out[:, i * n + j] = (a * f2p[:, :, i:i + h, j:j + w]).mean(1)
    return out.to(f1.dtype)


def normalize_features(feature_list, eps: float = 1e-16):
    """Normalize ``[B, C, H, W]`` tensors before correlation (UFlow recipe).

    Per-image biased mean/variance over (C, H, W), averaged across the
    batch and the list into one scalar pair; every tensor is centred by the
    mean and divided by ``sqrt(var + eps)``. Moments are computed in fp32
    whatever the input dtype; results come back in the input dtype.
    """
    means, variances = [], []
    for f in feature_list:
        f32 = f.float()
        mean = f32.mean(dim=(1, 2, 3), keepdim=True)
        means.append(mean.mean())
        variances.append(((f32 - mean) ** 2).mean())
    mean = torch.stack(means).mean()
    scale = torch.sqrt(torch.stack(variances).mean() + eps)
    return [((f.float() - mean) / scale).to(f.dtype) for f in feature_list]
