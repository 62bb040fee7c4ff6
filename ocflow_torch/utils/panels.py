"""Validation panels (port of ``ocflow_tpu/utils/panels.py``): uint8 image
grids, rows stacked top to bottom, from [-1, 1] images, flows and [H, W, 1]
masks. numpy."""

from __future__ import annotations

import numpy as np

from ocflow_torch.utils.viz import denormalize_image, flow_to_image


def _occ_u8(occ):
    """A ``[H, W, 1]`` mask in [0, 1] as a grey uint8 RGB image."""
    g = (np.asarray(occ)[..., 0] * 255).clip(0, 255).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def flow_panel(img1, img2, flow_pred, flow_gt=None):
    """Rows: frame 1, frame 2, the predicted flow's colours, (the ground
    truth's)."""
    rows = [denormalize_image(img1), denormalize_image(img2),
            flow_to_image(np.asarray(flow_pred))]
    if flow_gt is not None:
        rows.append(flow_to_image(np.asarray(flow_gt)))
    return np.concatenate(rows, axis=0)


def warp_panel(img1, img2, img_warped, flow_pred):
    """Rows: frame 1, frame 2, frame 2 warped to frame 1, the flow's
    colours."""
    return np.concatenate([denormalize_image(img1), denormalize_image(img2),
                           denormalize_image(img_warped),
                           flow_to_image(np.asarray(flow_pred))], axis=0)


def occlusion_panel(img1, img2, occ_pred, occ_gt=None):
    """Rows: frame 1, frame 2, the predicted occlusion, (the ground
    truth's)."""
    rows = [denormalize_image(img1), denormalize_image(img2), _occ_u8(occ_pred)]
    if occ_gt is not None:
        rows.append(_occ_u8(occ_gt))
    return np.concatenate(rows, axis=0)


def inpainting_panel(masked_img, recon, img, complete):
    """Rows: the masked input, the raw reconstruction, the frame, the
    composite."""
    return np.concatenate([denormalize_image(masked_img), denormalize_image(recon),
                           denormalize_image(img), denormalize_image(complete)], axis=0)


def pipeline_panel(img1, img2, flow_pred, img_warped, occ_pred, img_completed):
    """Rows: frame 1, frame 2, the flow's colours, frame 2 warped, the
    occlusion, the completed frame."""
    return np.concatenate([denormalize_image(img1), denormalize_image(img2),
                           flow_to_image(np.asarray(flow_pred)),
                           denormalize_image(img_warped), _occ_u8(occ_pred),
                           denormalize_image(img_completed)], axis=0)


def pipeline_grid(img1, img2, img_pred_warped, img_warped, img_occluded, img_completed,
                  flow_pred, flow_gt, occ_pred, occ_gt):
    """The ten-panel pipeline view as one 5 x 2 grid: frames 1 | 2; frame 2
    warped by the predicted | the true flow; the occluded | the completed
    frame; the predicted | true flow's colours; the predicted | true
    occlusion."""
    rows = [(denormalize_image(img1), denormalize_image(img2)),
            (denormalize_image(img_pred_warped), denormalize_image(img_warped)),
            (denormalize_image(img_occluded), denormalize_image(img_completed)),
            (flow_to_image(np.asarray(flow_pred)), flow_to_image(np.asarray(flow_gt))),
            (_occ_u8(occ_pred), _occ_u8(occ_gt))]
    return np.concatenate([np.concatenate(r, axis=1) for r in rows], axis=0)
