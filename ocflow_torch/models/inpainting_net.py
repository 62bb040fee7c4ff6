"""InpaintingNet, eager (port of ``ocflow_tpu/models/inpainting_net.py``): a
6-level projection-bottleneck U-Net image inpainter.

``forward(imgs, masks)``: ``imgs`` ``[B, H, W, 3]`` in [-1, 1], ``masks``
``[B, H, W, 1]`` with 1 = hole (NHWC, H and W divisible by 64). The hole is
zeroed (``masked = imgs * (1 - masks)``), the mask joins it as a 4th
channel, and the net predicts the completed image through a ``tanh``:

- ``down1..down6`` (:class:`~ocflow_torch.models.common.ProjDown`: 32, 64,
  128, 128, 128, 128 channels, the middle conv 7x7, 5x5, 5x5, then 3x3;
  ``down1`` with ``proj_ratio`` 1, the others 4), each 2x down;
- ``up1..up6`` (:class:`~ocflow_torch.models.common.ProjUp`: 128, 128,
  128 channels with ``proj_ratio`` 8, then 64, 32 and 3 with 4), each
  resizing 2x (the dense-matrix bilinear resize) onto the skip of its
  level; the last reads ``masked`` (3 channels, not the 4-channel input)
  and ends in a bias-free 1x1 conv with no BatchNorm and no LeakyReLU.

Every other conv is bias-free and followed by
:class:`~ocflow_torch.models.common.BatchNorm` (flax's train-mode update),
so serve it in eval mode. In fp32 the convolutions run in full fp32
(``ocflow_torch.full_fp32_convs``: cuDNN without TF32, fp32 matmuls for the
resize). The net launches no kernel of this repository. Parameter names are
the reference torch network's (``down1.conv1``, ``down1.bn1``, ...,
``up6.conv3``), which ``convert_inpainting_net`` of the JAX package maps
onto its flax tree.
"""

from __future__ import annotations

import torch
from torch import nn

from ocflow_torch import full_fp32_convs
from ocflow_torch.models.common import ProjDown, ProjUp, init_weights

# (channels, middle kernel, proj_ratio) of down1..down6
DOWN = ((32, 7, 1), (64, 5, 4), (128, 5, 4), (128, 3, 4), (128, 3, 4), (128, 3, 4))
# (channels, proj_ratio) of up1..up6
UP = ((128, 8), (128, 8), (128, 8), (64, 4), (32, 4), (3, 4))


class InpaintingNet(nn.Module):
    """See the module docstring. ``generator`` seeds the init
    (:func:`models.common.init_weights`)."""

    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        skips, cin = [3], 4
        for i, (c, k, ratio) in enumerate(DOWN, 1):
            self.add_module(f"down{i}", ProjDown(cin, c, ratio, kernel_size=k))
            skips.append(c)
            cin = c
        for i, (c, ratio) in enumerate(UP, 1):
            self.add_module(f"up{i}", ProjUp(skips[-1 - i] + cin, c, ratio,
                                             activation=i < len(UP)))
            cin = c
        if generator is not None:
            init_weights(self, generator)

    def forward(self, imgs: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        with full_fp32_convs(imgs.dtype):
            masked = (imgs * (1.0 - masks)).permute(0, 3, 1, 2).contiguous()
            x = torch.cat([masked, masks.permute(0, 3, 1, 2)], 1)
            skips = [masked]
            for i in range(1, len(DOWN) + 1):
                x = getattr(self, f"down{i}")(x)
                skips.append(x)
            for i in range(1, len(UP) + 1):
                x = getattr(self, f"up{i}")(x, skips[-1 - i])
        return torch.tanh(x).permute(0, 2, 3, 1).contiguous()
