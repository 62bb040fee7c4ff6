"""Validation panels (port of ``ocflow_tpu/utils/panels.py``'s flow and
warp panels): uint8 image grids, rows stacked top to bottom. numpy."""

from __future__ import annotations

import numpy as np

from ocflow_torch.utils.viz import denormalize_image, flow_to_image


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
