"""Edge-aware smoothness losses (port of ``ocflow_tpu/losses/smoothness.py``),
NCHW: the JAX package's channel reductions (``axis=-1``) are ``dim=1`` here.
Means accumulate in fp32."""

from __future__ import annotations

import torch

from ocflow_torch.losses.photometric import robust_l1


def image_gradient(img: torch.Tensor, stride: int = 1):
    """Forward differences along W then H: ``(dx [B, C, H, W-s], dy [B, C,
    H-s, W])``."""
    dx = img[:, :, :, stride:] - img[:, :, :, :-stride]
    dy = img[:, :, stride:, :] - img[:, :, :-stride, :]
    return dx, dy


def edge_aware_smoothness_loss(img: torch.Tensor, flow: torch.Tensor,
                               alpha: float = 100.0) -> torch.Tensor:
    """Norm-weighted variant."""
    img_dx, img_dy = image_gradient(img)
    flow_dx, flow_dy = image_gradient(flow)
    loss_dx = torch.linalg.vector_norm(flow_dx, dim=1) * torch.exp(
        -alpha * torch.linalg.vector_norm(img_dx, dim=1))
    loss_dy = torch.linalg.vector_norm(flow_dy, dim=1) * torch.exp(
        -alpha * torch.linalg.vector_norm(img_dy, dim=1))
    return 0.5 * (robust_l1(loss_dx).float().mean()
                  + robust_l1(loss_dy).float().mean())


def first_order_smoothness_loss(img: torch.Tensor, flow: torch.Tensor,
                                alpha: float = 100.0) -> torch.Tensor:
    """``exp(-mean_c((alpha dI)^2))``-weighted charbonnier of the flow's
    first differences."""
    img_gx, img_gy = image_gradient(img)
    weights_x = torch.exp(-((alpha * img_gx) ** 2).mean(1, keepdim=True))
    weights_y = torch.exp(-((alpha * img_gy) ** 2).mean(1, keepdim=True))
    flow_gx, flow_gy = image_gradient(flow)
    return 0.5 * ((weights_x * robust_l1(flow_gx)).float().mean()
                  + (weights_y * robust_l1(flow_gy)).float().mean())


def second_order_smoothness_loss(img: torch.Tensor, flow: torch.Tensor,
                                 alpha: float = 100.0) -> torch.Tensor:
    """Image gradients at stride 2 weighting the flow's second
    differences."""
    img_gx, img_gy = image_gradient(img, stride=2)
    weights_xx = torch.exp(-((alpha * img_gx) ** 2).mean(1, keepdim=True))
    weights_yy = torch.exp(-((alpha * img_gy) ** 2).mean(1, keepdim=True))
    flow_gx, flow_gy = image_gradient(flow)
    flow_gxx, _ = image_gradient(flow_gx)
    _, flow_gyy = image_gradient(flow_gy)
    return 0.5 * ((weights_xx * robust_l1(flow_gxx)).float().mean()
                  + (weights_yy * robust_l1(flow_gyy)).float().mean())
