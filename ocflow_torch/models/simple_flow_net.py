"""SimpleFlowNet, eager (port of ``ocflow_tpu/models/simple_flow_net.py``):
a U-Net flow predictor with per-level flow feedback.

A 5-level projection-bottleneck encoder (``down1..down5``: 16, 32, 64, 96,
128 channels, each 2x down), then a bilinear-upsample decoder with skips
(``up1..up5``: 96, 64, 32, 16, 16 channels); before each decoder level the
flow predicted so far (``predict_flow5..predict_flow1``, a
``PredictFlowStack`` each) is concatenated back into the features; the
last up block reads the input frames as its skip and ``predict_flow0``
gives the full-resolution flow. No cost volume: the net launches no kernel
of this repository. Every conv but the flow heads' is followed by
:class:`~ocflow_torch.models.common.BatchNorm`, so serve it in eval mode.

Parameter names are the reference torch network's (``down1.conv1``,
``down1.bn1``, ..., ``up5.bn3``, ``predict_flow5.0.0`` ...
``predict_flow0.2.0``), which ``convert_simpleflownet`` of the JAX package
maps onto its flax tree.
"""

from __future__ import annotations

import torch
from torch import nn

from ocflow_torch import full_fp32_convs
from ocflow_torch.models.common import PredictFlowStack, ProjDown, ProjUp, init_weights

# (channels, proj_ratio) of down1..down5; channels of up1..up5
DOWN = ((16, 1), (32, 2), (64, 4), (96, 4), (128, 4))
UP = (96, 64, 32, 16, 16)


class SimpleFlowNet(nn.Module):
    """``[B, H, W, in_channels]`` (two frames on channels) -> the flow
    ``[B, H, W, 2]`` (NHWC; H and W divisible by 32). ``generator`` seeds
    the init (:func:`models.common.init_weights`). The heads are
    ``predict_<HEAD><k>``, built by :meth:`_head` (SimpleOcclusionNet puts
    occlusion heads on the same U-Net)."""

    HEAD = "flow"

    def __init__(self, in_channels: int = 6, out_channels: int = 2,
                 generator: torch.Generator | None = None):
        super().__init__()
        skips = [in_channels]
        cin = in_channels
        for i, (c, ratio) in enumerate(DOWN, 1):
            self.add_module(f"down{i}", ProjDown(cin, c, ratio))
            skips.append(c)
            cin = c
        for i, c in enumerate(UP, 1):
            self.add_module(f"predict_{self.HEAD}{6 - i}", self._head(cin, out_channels))
            self.add_module(f"up{i}", ProjUp(skips[-1 - i] + cin + out_channels, c))
            cin = c
        self.add_module(f"predict_{self.HEAD}0", self._head(cin, out_channels))
        if generator is not None:
            init_weights(self, generator)

    def _head(self, cin: int, cout: int) -> nn.Module:
        return PredictFlowStack(cin, cout)

    def forward(self, x):
        with full_fp32_convs(x.dtype):
            skips = [x.permute(0, 3, 1, 2).contiguous()]
            for i in range(1, len(DOWN) + 1):
                skips.append(getattr(self, f"down{i}")(skips[-1]))
            h = skips[-1]
            for i in range(1, len(UP) + 1):
                head = getattr(self, f"predict_{self.HEAD}{6 - i}")(h)
                h = getattr(self, f"up{i}")(torch.cat([h, head], 1), skips[-1 - i])
            out = getattr(self, f"predict_{self.HEAD}0")(h)
        return out.permute(0, 2, 3, 1).contiguous()
