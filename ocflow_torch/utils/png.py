"""A PNG writer in the standard library (``zlib`` and ``struct``): 8- or
16-bit gray, gray+alpha, RGB or RGBA, not interlaced. It writes the
validation panels, the inference CLI's flow images and KITTI's 16-bit flow
PNGs, where the JAX package uses imageio and OpenCV. The reader is
``ocflow_torch.data.native_io``."""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type by channel count: gray, gray + alpha, RGB, RGBA
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_rows(rows: np.ndarray, bpp: int, filters) -> np.ndarray:
    """PNG row filtering of ``rows`` (uint8 ``[H, N]``, the raw bytes of
    each scanline; ``bpp`` bytes per pixel): row ``y`` is filtered with type
    ``filters[y]`` (0 none, 1 Sub, 2 Up, 3 Average, 4 Paeth; an int applies
    to every row). Returns ``[H, 1 + N]`` uint8, each row led by its type.
    Filtering reads only unfiltered bytes, so each type runs on all its rows
    at once."""
    h, n = rows.shape
    types = np.broadcast_to(np.asarray(filters, np.uint8), (h,))
    out = np.empty((h, 1 + n), np.uint8)
    out[:, 0] = types
    out[:, 1:] = rows
    for t in np.unique(types[types > 0]):
        idx = np.nonzero(types == t)[0]
        x = rows[idx].astype(np.int16)
        up = np.where((idx > 0)[:, None], rows[idx - 1], 0).astype(np.int16)
        left = np.zeros_like(x)
        left[:, bpp:] = x[:, :-bpp]
        if t == 1:
            pred = left
        elif t == 2:
            pred = up
        elif t == 3:
            pred = (left + up) // 2
        else:
            upleft = np.zeros_like(x)
            upleft[:, bpp:] = up[:, :-bpp]
            pred = _paeth(left, up, upleft)
        out[idx, 1:] = ((x - pred) & 0xFF).astype(np.uint8)
    return out


def encode_png(img: np.ndarray, filters=0) -> bytes:
    """The PNG bytes of ``img``: uint8 or uint16, ``[H, W]`` or ``[H, W,
    C]`` with C in 1 (gray), 2 (gray + alpha), 3 (RGB), 4 (RGBA); 16-bit
    samples big-endian, as PNG stores them. ``filters``: the row filter
    types (see :func:`filter_rows`; 0, none, by default)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    if img.dtype not in (np.uint8, np.uint16) or img.ndim != 3 \
            or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"want a uint8 or uint16 [H, W, 1-4] image, got {img.dtype} "
                         f"{img.shape}")
    h, w, c = img.shape
    depth = 8 * img.itemsize
    raw = img.astype(">u2") if depth == 16 else img
    rows = np.ascontiguousarray(raw).view(np.uint8).reshape(h, w * c * img.itemsize)
    data = filter_rows(rows, c * img.itemsize, filters)
    header = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPE[c], 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(data.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path, img: np.ndarray, filters=0) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img, filters))
