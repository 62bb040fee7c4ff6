"""Shared building blocks (port of ``ocflow_tpu/models/common.py``), NCHW.

Parameter names follow the reference torch networks, so that a module's
``state_dict`` maps onto the JAX package's flax tree through the converters
in ``ocflow_tpu/models/torch_convert.py``:

- ``ConvBlock`` is ``Sequential(Conv2d, LeakyReLU(0.1))`` (keys ``<name>.0``);
- ``Deconv`` is ``ConvTranspose2d(k=4, s=2, p=1)``, which equals flax
  ``ConvTranspose(4, s2, 'SAME')`` with the kernel spatially flipped;
- ``PredictFlow`` is a bare 3x3 conv to 2 channels.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class ConvBlock(nn.Sequential):
    """3x3 conv with torch padding ``dilation`` and LeakyReLU(0.1)."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 dilation: int = 1, device=None, dtype=None):
        super().__init__(
            nn.Conv2d(cin, cout, 3, stride=stride, padding=dilation,
                      dilation=dilation, device=device, dtype=dtype),
            nn.LeakyReLU(0.1))


class Deconv(nn.ConvTranspose2d):
    """2x transposed-conv upsampling, no activation."""

    def __init__(self, cin: int, cout: int = 2, device=None, dtype=None):
        super().__init__(cin, cout, 4, stride=2, padding=1, device=device,
                         dtype=dtype)


class PredictFlow(nn.Conv2d):
    """3x3 conv flow head."""

    def __init__(self, cin: int, cout: int = 2, device=None, dtype=None):
        super().__init__(cin, cout, 3, padding=1, device=device, dtype=dtype)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init of every conv / transposed conv: LeCun-normal weights
    (std 1/sqrt(fan_in), flax's default conv init) and uniform biases in
    +-1/sqrt(fan_in). The fan-in of a stride-2 4x4 transposed conv is 4
    taps per input channel."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.ConvTranspose2d):
                fan_in = m.weight.shape[0] * 4
            elif isinstance(m, nn.Conv2d):
                fan_in = m.weight.shape[1] * 9
            else:
                continue
            nn.init.normal_(m.weight, 0.0, 1.0 / math.sqrt(fan_in),
                            generator=generator)
            bound = 1.0 / math.sqrt(fan_in)
            nn.init.uniform_(m.bias, -bound, bound, generator=generator)
