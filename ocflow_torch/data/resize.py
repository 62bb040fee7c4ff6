"""Bilinear resize of host images as OpenCV computes
``cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR)``, in
numpy: the JAX package resizes its dataset frames, occlusion masks and
flows with that call, and the port keeps the same numbers without OpenCV.

Both axes map a destination index ``d`` to the source coordinate
``f = float32((d + 0.5) * (src / dst) - 0.5)`` (the scale in double), the
left tap ``s = floor(f)`` and the weight ``f - s``. Along x a tap left of
the image or at its last column is clamped with weight 0; along y the two
rows are clamped into the image and the weights kept. float32 images mix
the taps in fp32. uint8 images use OpenCV's fixed point: 11-bit weights
``rint(w * 2048)``, an integer horizontal sum ``D``, then vertically
``((b0 * (D0 >> 4)) >> 16) + ((b1 * (D1 >> 4)) >> 16)`` rounded by
``(v + 2) >> 2``, the form of its vector path (bit for bit at every width
tried, 1 to 1242 columns of 1 or 3 channels). float32 images of 1, 3 or 4
channels go through Intel IPP in OpenCV's x86 builds, whose coordinates
and weights stay in double; those are mixed with double coordinates here
(within 1.2e-5 of OpenCV on values of +-40, exact for 2 channels).
(``F.interpolate``'s bilinear differs from OpenCV by up to 6e-3 at
non-integer ratios.)
"""

from __future__ import annotations

import numpy as np

COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS


def _taps(src: int, dst: int, clamp_weight: bool, f32_coords: bool = True):
    """Left tap, right tap and the right tap's fp32 weight per destination
    index along one axis (``f32_coords`` False: the coordinate and weight
    in double, the weight then rounded to fp32)."""
    scale = 1.0 / (dst / src)
    f = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    if f32_coords:
        f = f.astype(np.float32)
    s = np.floor(f).astype(np.int64)
    w = f - s.astype(f.dtype)
    if clamp_weight:
        edge = (s < 0) | (s >= src - 1)
        w = np.where(edge, np.float32(0), w)
        s = np.clip(s, 0, src - 1)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w.astype(np.float32)


def resize_linear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=cv2.INTER_LINEAR)``
    of a uint8 or float32 ``[H, W]`` or ``[H, W, C]`` image. Like OpenCV,
    a ``[H, W, 1]`` image comes back ``[height, width]``."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.float32):
        raise ValueError(f"resize_linear: uint8 or float32, got {img.dtype}")
    squeeze = img.ndim == 3 and img.shape[2] == 1
    x = img if img.ndim == 3 else img[..., None]
    h, w, c = x.shape
    # float32 images of 1, 3 or 4 channels: OpenCV hands them to Intel IPP,
    # whose coordinates stay in double; 2 channels (flows) and uint8 take
    # OpenCV's own fp32 coordinates
    f32_coords = img.dtype == np.uint8 or c == 2
    x0, x1, wx = _taps(w, width, True, f32_coords)
    y0, y1, wy = _taps(h, height, False, f32_coords)
    one = np.float32(1)
    if img.dtype == np.float32:
        ax0, ax1 = (one - wx)[:, None], wx[:, None]
        rows = x[:, x0] * ax0 + x[:, x1] * ax1  # [h, width, c] fp32
        out = rows[y0] * (one - wy)[:, None, None] + rows[y1] * wy[:, None, None]
    else:
        scale = np.float32(1 << COEF_BITS)
        ax0 = np.rint((one - wx) * scale).astype(np.int32)[:, None]
        ax1 = np.rint(wx * scale).astype(np.int32)[:, None]
        by0 = np.rint((one - wy) * scale).astype(np.int64)[:, None]
        by1 = np.rint(wy * scale).astype(np.int64)[:, None]
        xi = x.astype(np.int32)
        rows = (xi[:, x0] * ax0 + xi[:, x1] * ax1).reshape(h, width * c)
        d0, d1 = rows[y0].astype(np.int64), rows[y1].astype(np.int64)
        out = (((by0 * (d0 >> 4)) >> 16) + ((by1 * (d1 >> 4)) >> 16) + 2) >> 2
        out = np.clip(out, 0, 255).astype(np.uint8).reshape(height, width, c)
    if img.ndim == 2 or squeeze:
        out = out[..., 0]
    return np.ascontiguousarray(out, dtype=img.dtype)
