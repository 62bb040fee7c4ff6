"""Optical-flow file IO (port of ``ocflow_tpu/data/flow_io.py``):
Middlebury ``.flo``, KITTI 16-bit PNG flow, PFM, and the host flow resize.

Host-side numpy, on the port's own decoder (``native_io``) and PNG writer
(``utils.png``) where the JAX package calls libpng and OpenCV.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from ocflow_torch.data import native_io
from ocflow_torch.data.resize import resize_linear
from ocflow_torch.utils.png import write_png

TAG_FLOAT = 202021.25  # Middlebury .flo magic


def read_flo(path) -> np.ndarray:
    """A Middlebury ``.flo`` file -> ``[H, W, 2]`` float32."""
    return native_io.decode_flo(Path(path).read_bytes(), path)


def write_flo(path, flow: np.ndarray) -> None:
    """Write ``[H, W, 2]`` float32 to a ``.flo`` file."""
    flow = np.asarray(flow, np.float32)
    h, w, c = flow.shape
    if c != 2:
        raise ValueError(f"write_flo: want [H, W, 2], got {flow.shape}")
    with open(path, "wb") as f:
        f.write(np.float32(TAG_FLOAT).tobytes())
        f.write(np.int32(w).tobytes())
        f.write(np.int32(h).tobytes())
        f.write(flow.tobytes())


def read_kitti_png_flow(path) -> np.ndarray:
    """KITTI flow PNG (16-bit RGB: ``u = (R - 2^15) / 64``, ``v = (G -
    2^15) / 64``, ``valid = B``) -> ``[H, W, 3]`` float64 ``(u, v,
    valid)``."""
    raw = native_io.read_image(path)
    if raw.dtype != np.uint16 or raw.shape[-1] < 3:
        raise ValueError(f"{path}: a KITTI flow PNG is 16-bit RGB, got "
                         f"{raw.dtype} with {raw.shape[-1]} channels")
    raw = raw.astype(np.float64)
    flow = np.zeros(raw.shape[:2] + (3,), np.float64)
    flow[..., 0] = (raw[..., 0] - 2.0 ** 15) / 64.0
    flow[..., 1] = (raw[..., 1] - 2.0 ** 15) / 64.0
    flow[..., 2] = raw[..., 2]
    return flow


def write_kitti_png_flow(path, flow: np.ndarray) -> None:
    """Write ``[H, W, 2]`` flow as a KITTI 16-bit PNG, every pixel valid."""
    h, w = flow.shape[:2]
    out = np.ones((h, w, 3), np.uint16)
    out[..., 0] = np.clip(flow[..., 0] * 64.0 + 2 ** 15, 0, 65535).astype(np.uint16)
    out[..., 1] = np.clip(flow[..., 1] * 64.0 + 2 ** 15, 0, 65535).astype(np.uint16)
    write_png(path, out)


def read_pfm(path):
    """A PFM file -> ``(data, scale)``, rows top to bottom."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"{path}: not a PFM file")
        dims = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dims:
            raise ValueError(f"{path}: malformed PFM header")
        width, height = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.reshape(data, shape)[::-1], scale


def resize_flow_np(flow: np.ndarray, height: int, width: int) -> np.ndarray:
    """Resize ``[H, W, 2]`` float32 flow (OpenCV's bilinear, see
    ``data.resize``) and rescale u by the width ratio, v by the height
    ratio."""
    h, w = flow.shape[:2]
    out = resize_linear(np.asarray(flow, np.float32), height, width)
    out[..., 0] *= width / w
    out[..., 1] *= height / h
    return out
