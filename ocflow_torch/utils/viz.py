"""Flow colouring (the Middlebury wheel) and image conversion: the port's
own copy of ``ocflow_tpu/utils/viz.py``'s numpy functions."""

from __future__ import annotations

import numpy as np

UNKNOWN_FLOW_THRESH = 1e7


def make_color_wheel() -> np.ndarray:
    """55-color Middlebury wheel (reference flow_utils.py:467-499)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col : col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col : col + YG, 1] = 255
    col += YG
    wheel[col : col + GC, 1] = 255
    wheel[col : col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col : col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col : col + CB, 2] = 255
    col += CB
    wheel[col : col + BM, 2] = 255
    wheel[col : col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col : col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col : col + MR, 0] = 255
    return wheel


def compute_color(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Map (u, v) to RGB via the color wheel (reference flow_utils.py:405-464)."""
    h, w = u.shape
    img = np.zeros((h, w, 3))
    nan_idx = np.isnan(u) | np.isnan(v)
    u = np.where(nan_idx, 0, u)
    v = np.where(nan_idx, 0, v)
    wheel = make_color_wheel()
    ncols = wheel.shape[0]
    rad = np.sqrt(u**2 + v**2)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1) + 1
    k0 = np.floor(fk).astype(int)
    k1 = np.where(k0 + 1 == ncols + 1, 1, k0 + 1)
    f = fk - k0
    for i in range(3):
        tmp = wheel[:, i]
        col0 = tmp[k0 - 1] / 255
        col1 = tmp[k1 - 1] / 255
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] *= 0.75
        img[:, :, i] = np.floor(255 * col * (1 - nan_idx)).astype(np.uint8)
    return img


def flow_to_image(flow: np.ndarray) -> np.ndarray:
    """[H, W, 2] flow → uint8 RGB (reference flow_utils.py:140-177)."""
    u, v = flow[..., 0].copy(), flow[..., 1].copy()
    unknown = (np.abs(u) > UNKNOWN_FLOW_THRESH) | (np.abs(v) > UNKNOWN_FLOW_THRESH)
    u[unknown] = 0
    v[unknown] = 0
    rad = np.sqrt(u**2 + v**2)
    maxrad = max(-1.0, float(rad.max()))
    u = u / (maxrad + np.finfo(float).eps)
    v = v / (maxrad + np.finfo(float).eps)
    img = compute_color(u, v)
    img[unknown] = 0
    return np.uint8(img)


def denormalize_image(img: np.ndarray) -> np.ndarray:
    """[-1, 1] float → uint8 (reference img2photo, model.py:116-120)."""
    return ((np.asarray(img) + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
