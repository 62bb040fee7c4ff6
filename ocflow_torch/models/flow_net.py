"""FlowNet, eager (port of ``ocflow_tpu/models/flow_net.py``): the PWC
variant on a shared feature pyramid.

Both frames go through one ``FeaturePyramidNet`` (two calls, so in train
mode each frame's batch is normalized by its own statistics and the running
ones are updated twice, as the JAX module does). Coarse to fine over
``[p6 .. p2]``: frame 2's level warped by the upsampled flow times
``20 / 2**level`` (``align_corners=False``; level 6 unwarped), the d=4 cost
volume of frame 1's level and the warped one, a per-level
``OpticalFlowEstimator`` on ``cat([corr, f1, flow_up, feat_up])``, then the
``ContextNetwork`` residual and a 4x bilinear upsample. The reference
deliberately leaves out the x20 output scale; so does the port.

The cost volume is ``ocflow_torch.kernels.cost_volume.cost_volume``
through this module's name ``cost_volume``: the hand-written kernel (and
its backward kernel) for CUDA tensors, the plain version for CPU tensors.

Parameter names are the reference's (``feature_pyramid_network.*``,
``opticalflow_estimators.{0..4}.*``, ``context_network.*``), which
``convert_flownet_fpn`` of the JAX package maps onto its flax tree.
"""

from __future__ import annotations

import torch
from torch import nn

from ocflow_torch import full_fp32_convs
from ocflow_torch.kernels.cost_volume import cost_volume
from ocflow_torch.models.common import init_weights
from ocflow_torch.models.feature_pyramid import (FPN_CHANNELS, ContextNetwork,
                                                 FeaturePyramidNet, OpticalFlowEstimator)
from ocflow_torch.ops.resize import resize_bilinear
from ocflow_torch.ops.warp import warp

# pyramid channels of p6 .. p2
PYRAMID = tuple(FPN_CHANNELS[lvl - 1] for lvl in (6, 5, 4, 3, 2))


def frames(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``[B, H, W, 6]`` -> the two frames NCHW."""
    return (x[..., :3].permute(0, 3, 1, 2).contiguous(),
            x[..., 3:].permute(0, 3, 1, 2).contiguous())


def upsample4(t: torch.Tensor) -> torch.Tensor:
    """4x bilinear (``align_corners=False``), NCHW -> NHWC."""
    t = resize_bilinear(t, t.shape[2] * 4, t.shape[3] * 4, align_corners=False)
    return t.permute(0, 2, 3, 1).contiguous()


class FlowNet(nn.Module):
    """``[B, H, W, 6]`` -> the flow ``[B, H, W, 2]`` (NHWC; H and W divisible
    by 64). ``generator`` seeds the init (:func:`models.common.init_weights`).
    Serve it in eval mode: the pyramid has BatchNorm."""

    def __init__(self, displacement: int = 4, generator: torch.Generator | None = None):
        super().__init__()
        self.displacement = displacement
        nk = (2 * displacement + 1) ** 2
        self.feature_pyramid_network = FeaturePyramidNet()
        self.opticalflow_estimators = nn.ModuleList(
            OpticalFlowEstimator(nk + c + (4 if i else 0), highest_resolution=i == 4)
            for i, c in enumerate(PYRAMID))
        self.context_network = ContextNetwork(32 + 2)
        if generator is not None:
            init_weights(self, generator)

    def forward(self, x):
        with full_fp32_convs(x.dtype):
            im1, im2 = frames(x)
            pyr1 = self.feature_pyramid_network(im1)
            pyr2 = self.feature_pyramid_network(im2)
            flow_up = feat_up = None
            for i, (f1, f2, est) in enumerate(zip(pyr1, pyr2, self.opticalflow_estimators)):
                level = 6 - i
                warped = f2 if i == 0 else warp(f2, flow_up * (20.0 / 2.0 ** level),
                                                align_corners=False)
                inputs = [cost_volume(f1, warped, self.displacement), f1]
                if i:
                    inputs += [flow_up, feat_up]
                if level == 2:
                    flow, feat = est(torch.cat(inputs, 1))
                else:
                    flow, flow_up, feat_up = est(torch.cat(inputs, 1))
            flow = flow + self.context_network(torch.cat([feat, flow], 1))
            return upsample4(flow)
