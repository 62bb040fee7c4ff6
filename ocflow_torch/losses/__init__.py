"""Losses of the training steps (NCHW; the reconstruction losses any
layout whose mask broadcasts; the GAN hinge losses any shape)."""

from ocflow_torch.losses.classification import binary_cross_entropy, focal_bce_loss
from ocflow_torch.losses.gan import sn_dis_loss, sn_gen_loss
from ocflow_torch.losses.photometric import (census_loss, census_transform,
                                             photometric_error, robust_l1)
from ocflow_torch.losses.reconstruction import masked_l1_loss, recon_loss
from ocflow_torch.losses.smoothness import (edge_aware_smoothness_loss,
                                            first_order_smoothness_loss, image_gradient,
                                            second_order_smoothness_loss)

__all__ = [
    "binary_cross_entropy", "census_loss", "census_transform",
    "edge_aware_smoothness_loss", "first_order_smoothness_loss", "focal_bce_loss",
    "image_gradient", "masked_l1_loss", "photometric_error", "recon_loss", "robust_l1",
    "second_order_smoothness_loss", "sn_dis_loss", "sn_gen_loss",
]
