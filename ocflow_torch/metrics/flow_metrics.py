"""Flow quality metrics (port of ``ocflow_tpu/metrics/flow_metrics.py``):
EPE and the KITTI outlier rate on NHWC tensors, on their own device.

Unknown flow (|u| or |v| above 1e7) is left out; an occlusion mask (1 =
occluded) leaves out the occluded pixels.
"""

from __future__ import annotations

import torch

UNKNOWN_FLOW_THRESH = 1e7


def flow_error(tu, tv, u, v, occ=None, unknown_thresh: float = UNKNOWN_FLOW_THRESH):
    """Mean EPE between ground truth ``(tu, tv)`` and estimate ``(u, v)``,
    ``[H, W]`` tensors; ``occ`` ``[H, W]``, 1 = occluded (left out)."""
    known = (tu.abs() <= unknown_thresh) & (tv.abs() <= unknown_thresh)
    if occ is not None:
        known = known & (occ == 0)
    epe = torch.sqrt((tu - u) ** 2 + (tv - v) ** 2)
    return torch.where(known, epe, 0.0).sum() / known.sum().clamp(min=1)


def evaluate_flow(gt_flow, pred_flow, occ=None):
    """Mean EPE of ``[H, W, 2]`` flows, or the mean over images of each
    image's EPE for ``[B, H, W, 2]`` (``occ`` is not used then, as in the
    JAX package)."""
    if gt_flow.dim() == 4:
        return torch.stack([flow_error(g[..., 0], g[..., 1], p[..., 0], p[..., 1])
                            for g, p in zip(gt_flow, pred_flow)]).mean()
    return flow_error(gt_flow[..., 0], gt_flow[..., 1], pred_flow[..., 0],
                      pred_flow[..., 1], occ=occ)


def flow_kitti_error(tu, tv, u, v, mask=None, tau=(3.0, 0.05)):
    """KITTI metric: ``(EPE over valid pixels, 1 - outlier rate)``, an
    outlier having EPE > ``tau[0]`` and EPE / |gt| > ``tau[1]``."""
    if mask is None:
        mask = torch.ones_like(tu)
    valid = mask > 1e-7
    epe = torch.sqrt((tu - u) ** 2 + (tv - v) ** 2)
    mag = torch.sqrt(tu ** 2 + tv ** 2) + 1e-5
    outlier = (epe > tau[0]) & (epe / mag > tau[1])
    n = valid.sum().clamp(min=1)
    aepe = torch.where(valid, epe, 0.0).sum() / n
    acc = 1.0 - (valid & outlier).sum() / n
    return aepe, acc


def evaluate_kitti_flow(gt, pred, tau=(3.0, 0.05)):
    """``gt``: ``[H, W, 2]``, or ``[H, W, 3]`` with a validity channel."""
    mask = gt[..., 2] if gt.shape[-1] == 3 else None
    return flow_kitti_error(gt[..., 0], gt[..., 1], pred[..., 0], pred[..., 1],
                            mask=mask, tau=tau)


def occlusion_f1(pred, target, threshold: float = 0.5, eps: float = 1e-9):
    """F1 score of the binarized occlusion mask (1 = occluded)."""
    p = (pred > threshold).float()
    t = (target > threshold).float()
    tp = (p * t).sum()
    precision = tp / (p.sum() + eps)
    recall = tp / (t.sum() + eps)
    return 2.0 * precision * recall / (precision + recall + eps)


def calculate_average_epe(predict_fn, batches):
    """EPE over a loader, weighted by batch size: ``predict_fn(images) ->
    flow``; batches are dicts with ``images`` and ``flow``."""
    total, count = 0.0, 0
    for batch in batches:
        pred = predict_fn(batch["images"])
        n = batch["flow"].shape[0]
        total += float(evaluate_flow(batch["flow"], pred)) * n
        count += n
    return total / max(count, 1)
