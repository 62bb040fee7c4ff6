"""Bilinear resize with ``F.interpolate`` semantics, as two dense matmuls.

Port of ``ocflow_tpu/ops/resize.py`` in NCHW: ``out = My @ img @ Mx^T`` with
edge-clamped interpolation matrices, for both ``align_corners`` conventions.
"""

from __future__ import annotations

import numpy as np
import torch


def _interp_matrix(n_in: int, n_out: int, align_corners: bool) -> np.ndarray:
    """``[n_out, n_in]`` bilinear interpolation matrix (edge-clamped)."""
    if n_out == n_in:
        return np.eye(n_out, dtype=np.float32)
    i = np.arange(n_out, dtype=np.float64)
    if align_corners and n_out > 1:
        src = i * (n_in - 1) / (n_out - 1)
    else:
        src = (i + 0.5) * n_in / n_out - 0.5
    src = np.clip(src, 0.0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    t = src - lo
    m = np.zeros((n_out, n_in), dtype=np.float64)
    m[np.arange(n_out), lo] += 1.0 - t
    m[np.arange(n_out), hi] += t
    return m.astype(np.float32)


def resize_bilinear(img: torch.Tensor, height: int, width: int,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of ``[B, C, H, W]`` to ``(height, width)``."""
    _, _, h, w = img.shape
    my = torch.from_numpy(_interp_matrix(h, height, align_corners)).to(
        device=img.device, dtype=img.dtype)
    mx = torch.from_numpy(_interp_matrix(w, width, align_corners)).to(
        device=img.device, dtype=img.dtype)
    out = torch.einsum("oh,bchw->bcow", my, img)
    return torch.einsum("pw,bcow->bcop", mx, out)
