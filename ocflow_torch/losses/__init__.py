"""Losses of the unsupervised flow step (NCHW)."""

from ocflow_torch.losses.classification import binary_cross_entropy
from ocflow_torch.losses.photometric import (census_loss, census_transform,
                                             photometric_error, robust_l1)
from ocflow_torch.losses.smoothness import (edge_aware_smoothness_loss,
                                            first_order_smoothness_loss, image_gradient,
                                            second_order_smoothness_loss)

__all__ = [
    "binary_cross_entropy", "census_loss", "census_transform",
    "edge_aware_smoothness_loss", "first_order_smoothness_loss",
    "image_gradient", "photometric_error", "robust_l1",
    "second_order_smoothness_loss",
]
