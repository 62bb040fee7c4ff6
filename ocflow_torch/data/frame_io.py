"""The generic frame reader (port of ``ocflow_tpu/data/frame_io.py``)."""

from __future__ import annotations

import os

import numpy as np

from ocflow_torch.data import native_io
from ocflow_torch.data.flow_io import read_flo, read_pfm


def read_gen(path) -> np.ndarray:
    """Dispatch on the extension: ``.png`` / ``.jpg`` / ``.jpeg`` / ``.ppm``
    / ``.pgm`` -> an image ``[H, W, C]`` (uint8, or uint16 for 16-bit PNGs)
    with C 1 or 3 (alpha dropped; the host decoder of ``native_io``, baseline
    JPEG only), ``.flo`` -> flow, ``.pfm`` -> its data, ``.bin`` / ``.raw``
    -> ``np.load``."""
    ext = os.path.splitext(path)[-1].lower()
    if ext in (".png", ".jpg", ".jpeg", ".ppm", ".pgm"):
        im = native_io.read_image(path)
        return im[..., :3] if im.shape[-1] > 3 else im
    if ext == ".flo":
        return read_flo(path)
    if ext == ".pfm":
        return read_pfm(path)[0]
    if ext in (".bin", ".raw"):
        return np.load(path)
    raise ValueError(f"Unsupported extension: {path}")
