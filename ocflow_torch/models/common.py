"""Shared building blocks (port of ``ocflow_tpu/models/common.py`` and of
``PredictOcc`` in ``ocflow_tpu/models/occlusion_nets.py``), NCHW.

Parameter names follow the reference torch networks, so that a module's
``state_dict`` maps onto the JAX package's flax tree through the converters
in ``ocflow_tpu/models/torch_convert.py``:

- ``ConvBlock`` is ``Sequential(Conv2d, LeakyReLU(0.1))`` (keys
  ``<name>.0``), or with ``use_bn`` ``Sequential(Conv2d(bias=False),
  BatchNorm2d, LeakyReLU(0.1))`` (keys ``<name>.0``, ``<name>.1``);
- ``Deconv`` is ``ConvTranspose2d(k=4, s=2, p=1)``, which equals flax
  ``ConvTranspose(4, s2, 'SAME')`` with the kernel spatially flipped;
  ``FeatureDeconv`` is ``Sequential(Deconv, LeakyReLU(0.1))`` (keys
  ``<name>.0``), the JAX ``Deconv(act=True)``;
- ``PredictFlow`` is a bare 3x3 conv to 2 channels; ``PredictOcc`` is
  ``Sequential(Conv2d(cin, 1, 3, p1), Sigmoid)`` (keys ``<name>.0``).
"""

from __future__ import annotations

import math

import torch
from torch import nn


class ConvBlock(nn.Sequential):
    """Conv, optional BatchNorm, LeakyReLU(0.1); torch padding
    ``(k - 1) // 2 * dilation`` unless given. With ``use_bn`` the conv has
    no bias and BatchNorm follows (eps 1e-5, torch momentum 0.1 = flax
    momentum 0.9)."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 dilation: int = 1, device=None, dtype=None, *,
                 kernel_size: int = 3, padding: int | None = None,
                 use_bn: bool = False):
        if padding is None:
            padding = (kernel_size - 1) // 2 * dilation
        kw = dict(device=device, dtype=dtype)
        layers = [nn.Conv2d(cin, cout, kernel_size, stride=stride,
                            padding=padding, dilation=dilation,
                            bias=not use_bn, **kw)]
        if use_bn:
            layers.append(nn.BatchNorm2d(cout, eps=1e-5, momentum=0.1, **kw))
        super().__init__(*layers, nn.LeakyReLU(0.1))


class Deconv(nn.ConvTranspose2d):
    """2x transposed-conv upsampling, no activation."""

    def __init__(self, cin: int, cout: int = 2, device=None, dtype=None):
        super().__init__(cin, cout, 4, stride=2, padding=1, device=device,
                         dtype=dtype)


class FeatureDeconv(nn.Sequential):
    """2x transposed-conv upsampling then LeakyReLU(0.1)."""

    def __init__(self, cin: int, cout: int, device=None, dtype=None):
        super().__init__(Deconv(cin, cout, device=device, dtype=dtype),
                         nn.LeakyReLU(0.1))


class PredictFlow(nn.Conv2d):
    """3x3 conv flow head."""

    def __init__(self, cin: int, cout: int = 2, device=None, dtype=None):
        super().__init__(cin, cout, 3, padding=1, device=device, dtype=dtype)


class PredictOcc(nn.Sequential):
    """3x3 conv to one channel, then a sigmoid: occlusion probability."""

    def __init__(self, cin: int, device=None, dtype=None):
        super().__init__(nn.Conv2d(cin, 1, 3, padding=1, device=device,
                                   dtype=dtype), nn.Sigmoid())


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init, in module order: each conv / transposed conv gets
    LeCun-normal weights (std 1/sqrt(fan_in), flax's default conv init) and,
    where it has one, a uniform bias in +-1/sqrt(fan_in); each BatchNorm a
    scale in [0.5, 1.5], a bias and running mean in [-0.1, 0.1] and a
    running variance in [0.5, 2] (so that eval-mode BatchNorm is not the
    identity). The fan-in of a conv is ``cin * kh * kw``; of a transposed
    conv the taps that reach one output per input channel, ``cin * kh * kw
    / (sh * sw)`` (4 for the 4x4 stride-2 upsampler)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=generator)
                m.bias.uniform_(-0.1, 0.1, generator=generator)
                m.running_mean.uniform_(-0.1, 0.1, generator=generator)
                m.running_var.uniform_(0.5, 2.0, generator=generator)
                continue
            if isinstance(m, nn.ConvTranspose2d):
                cin, _, kh, kw = m.weight.shape
                fan_in = cin * kh * kw // (m.stride[0] * m.stride[1])
            elif isinstance(m, nn.Conv2d):
                fan_in = math.prod(m.weight.shape[1:])
            else:
                continue
            bound = 1.0 / math.sqrt(fan_in)
            nn.init.normal_(m.weight, 0.0, bound, generator=generator)
            if m.bias is not None:
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)
