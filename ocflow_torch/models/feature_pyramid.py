"""Feature pyramid and per-level estimators of the FPN flow nets, eager
(port of ``ocflow_tpu/models/feature_pyramid.py``), NCHW.

Parameter names are the reference torch networks' (``layer1.double_conv.0``
... ``pyr_top.0``, ``upsample5.deconv``, ``upsample5.batchnorm``; an
estimator's ``conv1`` ... ``conv6`` / ``feat_layer``, ``mask_layer``,
``upconv1``, ``upconv2``; the context network's ``conv1`` ... ``conv7``),
which ``_convert_fpn``, ``_convert_flow_estimator``,
``_convert_occ_estimator`` and ``_convert_context_net`` of the JAX package
map onto its flax trees.

The estimators' 2x upsamplers are ``ConvTranspose2d(k=3, s=2, p=1,
output_padding=1)``, the JAX package's flax transpose with explicit
``((1, 2), (1, 2))`` padding (the kernel flipped by the weight bridges).
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ocflow_torch.models.common import BatchNorm, ConvBlock

FPN_CHANNELS = (16, 32, 64, 96, 128, 196)
CONTEXT = ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1))


def _up3(cin: int, cout: int) -> nn.ConvTranspose2d:
    """The k3/s2/p1/op1 transposed conv: exactly 2x the input's size."""
    return nn.ConvTranspose2d(cin, cout, 3, stride=2, padding=1, output_padding=1)


class DoubleConv(nn.Module):
    """3x3 stride-2 conv then 3x3 conv, each without bias, with BatchNorm
    and LeakyReLU(0.1): ``double_conv.{0,1,3,4}``."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.double_conv = nn.Sequential(
            nn.Conv2d(cin, cout, 3, stride=2, padding=1, bias=False), BatchNorm(cout),
            nn.LeakyReLU(0.1),
            nn.Conv2d(cout, cout, 3, padding=1, bias=False), BatchNorm(cout),
            nn.LeakyReLU(0.1))

    def forward(self, x):
        return self.double_conv(x)


class FPNUp(nn.Module):
    """The k3/s2/p1/op1 transposed conv (with bias), cut to the skip's size,
    BatchNorm, LeakyReLU(0.1), plus the skip."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.deconv = _up3(cin, cout)
        self.batchnorm = BatchNorm(cout)

    def forward(self, x, skip):
        x = self.deconv(x)[:, :, :skip.shape[2], :skip.shape[3]]
        return F.leaky_relu(self.batchnorm(x), 0.1) + skip


class FeaturePyramidNet(nn.Module):
    """Six ``DoubleConv`` levels bottom-up (16 .. 196 channels), a 1x1
    ``pyr_top``, then top-down ``FPNUp`` fusions; returns ``[p6, p5, p4, p3,
    p2]``, coarse to fine (196, 128, 96, 64, 32 channels)."""

    def __init__(self, cin: int = 3):
        super().__init__()
        for i, c in enumerate(FPN_CHANNELS, 1):
            self.add_module(f"layer{i}", DoubleConv(cin, c))
            cin = c
        self.pyr_top = ConvBlock(cin, cin, kernel_size=1, padding=0, use_bn=True)
        for lvl in (5, 4, 3, 2):
            self.add_module(f"upsample{lvl}", FPNUp(FPN_CHANNELS[lvl], FPN_CHANNELS[lvl - 1]))

    def forward(self, x):
        cs = []
        for i in range(1, len(FPN_CHANNELS) + 1):
            x = getattr(self, f"layer{i}")(x)
            cs.append(x)
        pyr = [self.pyr_top(cs[5])]
        for lvl in (5, 4, 3, 2):
            pyr.append(getattr(self, f"upsample{lvl}")(pyr[-1], cs[lvl - 1]))
        return pyr


class ContextNetwork(nn.Module):
    """Dilated refiner ``conv1..conv6`` (LeakyReLU(0.1)) and the 3x3 head
    ``conv7`` to ``cout`` channels."""

    def __init__(self, cin: int, cout: int = 2):
        super().__init__()
        for j, (c, d) in enumerate(CONTEXT, 1):
            self.add_module(f"conv{j}", nn.Conv2d(cin, c, 3, padding=d, dilation=d))
            cin = c
        self.conv7 = nn.Conv2d(cin, cout, 3, padding=1)

    def forward(self, x):
        for j in range(1, len(CONTEXT) + 1):
            x = F.leaky_relu(getattr(self, f"conv{j}")(x), 0.1)
        return self.conv7(x)


class _Tower(nn.Module):
    """3x3 convs with LeakyReLU(0.1), registered under ``names``, then a 3x3
    head ``head`` to ``cout`` channels."""

    def __init__(self, cin, widths, names, head, cout, highest_resolution):
        super().__init__()
        self.names, self.head = names, head
        self.highest_resolution = highest_resolution
        for name, c in zip(names, widths):
            self.add_module(name, nn.Conv2d(cin, c, 3, padding=1))
            cin = c
        self.add_module(head, nn.Conv2d(cin, cout, 3, padding=1))

    def features(self, x):
        """``(the last conv's features, the head's output)``."""
        for name in self.names:
            x = F.leaky_relu(getattr(self, name)(x), 0.1)
        return x, getattr(self, self.head)(x)


class OpticalFlowEstimator(_Tower):
    """Flow tower 128/128/96/64/32 (``conv1..conv5``), head ``conv6`` to
    the flow. Returns ``(flow, features)`` at the highest resolution, else
    ``(flow, flow_up, feat_up)``: ``upconv1`` of the flow, ``upconv2`` of
    the 32 features, each to 2 channels."""

    def __init__(self, cin: int, highest_resolution: bool = False):
        super().__init__(cin, (128, 128, 96, 64, 32), [f"conv{j}" for j in range(1, 6)],
                         "conv6", 2, highest_resolution)
        if not highest_resolution:
            self.upconv1 = _up3(2, 2)
            self.upconv2 = _up3(32, 2)

    def forward(self, x):
        feat, flow = self.features(x)
        if self.highest_resolution:
            return flow, feat
        return flow, self.upconv1(flow), self.upconv2(feat)


class OcclusionEstimator(_Tower):
    """Occlusion tower 128/96/64/32 (``conv1..conv4``), 16 features
    (``feat_layer``), head ``mask_layer``. Returns ``sigmoid(10 x)`` at the
    highest resolution, else ``(sigmoid(x), sigmoid(upconv2(sigmoid(x))),
    sigmoid(upconv1(features)))``: occlusion, its 2x upsample and the
    features' 2x upsample, each one channel."""

    def __init__(self, cin: int, highest_resolution: bool = False):
        super().__init__(cin, (128, 96, 64, 32, 16),
                         ["conv1", "conv2", "conv3", "conv4", "feat_layer"],
                         "mask_layer", 1, highest_resolution)
        if not highest_resolution:
            self.upconv1 = _up3(16, 1)
            self.upconv2 = _up3(1, 1)

    def forward(self, x):
        feat, occ = self.features(x)
        if self.highest_resolution:
            return (10.0 * occ).sigmoid()
        occ = occ.sigmoid()
        return occ, self.upconv2(occ).sigmoid(), self.upconv1(feat).sigmoid()
