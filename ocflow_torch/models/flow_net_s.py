"""FlowNetC and FlowNetS, eager (port of ``ocflow_tpu/models/flow_net_s.py``),
the trunk FlowNetC shares with OcclusionNetC and FlowOccNetC, and the
FlowNetS trunk of FlowNetS, OcclusionNetS and FlowOccNetS
(:class:`FlowNetSFamily`: one encoder over the stacked frames, no cost
volume, the same decoder).

The trunk: a siamese encoder (conv1 7x7/s2, conv2 5x5/s2, conv3 5x5/s2, the
weights shared between the two frames), the cost volume of the two conv3
maps at d=10 (441 channels, 1/8 resolution) through a LeakyReLU(0.1), a 1x1
redirect conv of frame 1 to 32 channels, ``cat([redirect, correlation])``
(473 channels) into conv3_1, then conv4 .. conv6_1 (stride 2 at conv4,
conv5, conv6). Every conv is a ``ConvBlock`` with BatchNorm.

The correlation calls ``ocflow_torch.kernels.cost_volume.cost_volume``
through this module's name ``cost_volume``: the hand-written kernel for CUDA
tensors, the plain version for CPU tensors (the JAX module's
``cost_volume_fused``). The other convolutions are cuDNN, as they are XLA
convolutions in the JAX package.

Serving is ``model.eval()`` in fp32, what the JAX package computes
(``infer.py``: ``net.apply(variables, x)``, ``train=False``). A model left
in train mode normalizes with the batch's statistics and updates the running
ones: a different function. In fp32 the forwards run their cuDNN
convolutions in full fp32 (``ocflow_torch.full_fp32_convs``), whatever
PyTorch's TF32 flag says.

Parameter names are the reference torch network's (``conv1.0``,
``conv1.1``, ..., ``conv_redir``, ``conv3_1`` ... ``conv6_1``,
``predict_flow6`` ... ``predict_flow2``, ``upsampled_flow6_to_5`` ...,
``deconv5.0`` ... ``deconv2.0``), which ``convert_flownetc`` of the JAX
package maps onto its flax tree.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ocflow_torch import full_fp32_convs
from ocflow_torch.kernels.cost_volume import cost_volume
from ocflow_torch.models.common import (ConvBlock, Deconv, FeatureDeconv, PredictFlow,
                                        PredictOcc, init_weights)
from ocflow_torch.ops.resize import resize_bilinear

# (name, cin, cout, kernel, stride) after the siamese conv1..conv3;
# conv3_1 also reads the correlation
TRUNK_CONVS = (("conv_redir", 256, 32, 1, 1), ("conv3_1", 32, 256, 3, 1),
               ("conv4", 256, 512, 3, 2), ("conv4_1", 512, 512, 3, 1),
               ("conv5", 512, 512, 3, 2), ("conv5_1", 512, 512, 3, 1),
               ("conv6", 512, 1024, 3, 2), ("conv6_1", 1024, 1024, 3, 1))
LEVELS = (6, 5, 4, 3, 2)
# the trunk's skip at each level (level 2: conv2 of frame 1)
SKIP_CHANNELS = {6: 1024, 5: 512, 4: 512, 3: 256, 2: 128}
# deconv<k>: the features of level k + 1 upsampled to level k
DECONV_CHANNELS = {5: 512, 4: 256, 3: 128, 2: 64}
HEAD_CHANNELS = {"flow": 2, "occ": 1}


class FlowNetCFamily(nn.Module):
    """The FlowNetC family: the shared trunk (see the module docstring),
    then a FlowNetS-style decoder with the heads ``HEADS`` (``"flow"``:
    ``PredictFlow``, ``"occ"``: ``PredictOcc``). Per level 6..3, in this
    order: each head, each head's up-deconv (``upsampled_<head><k>_to_<k-1>``,
    with bias) and the feature deconv ``deconv<k-1>``; the next level reads
    ``cat([skip, deconv, *heads_up])``. Level 2's heads are resized 4x
    (bilinear, ``align_corners=False``).

    ``forward`` takes ``[B, H, W, 6]`` (two frames on channels, H and W
    divisible by 64) and returns each head ``[B, H, W, c]`` in NHWC (one
    tensor for one head, else a tuple in ``HEADS`` order).

    Serve it in eval mode (``model.eval()``): in train mode BatchNorm uses
    the batch's statistics, which is not the function the JAX package
    serves. ``generator`` seeds the init, BatchNorm statistics included
    (:func:`models.common.init_weights`); without it the layers keep
    PyTorch's default init. A family on another trunk overrides
    ``_build_trunk`` and ``trunk`` (:class:`FlowNetSFamily`).
    """

    HEADS: tuple[str, ...] = ()
    DISPLACEMENT = 10  # 441 correlation channels

    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        self._build_trunk()
        n_up = sum(HEAD_CHANNELS[h] for h in self.HEADS)
        cin = SKIP_CHANNELS[6]
        for lvl in LEVELS:
            for h in self.HEADS:
                self.add_module(f"predict_{h}{lvl}",
                                PredictFlow(cin) if h == "flow" else PredictOcc(cin))
            if lvl == LEVELS[-1]:
                break
            for h in self.HEADS:
                c = HEAD_CHANNELS[h]
                self.add_module(f"upsampled_{h}{lvl}_to_{lvl - 1}", Deconv(c, c))
            dfeat = DECONV_CHANNELS[lvl - 1]
            self.add_module(f"deconv{lvl - 1}", FeatureDeconv(cin, dfeat))
            cin = SKIP_CHANNELS[lvl - 1] + dfeat + n_up
        if generator is not None:
            init_weights(self, generator)

    def _build_trunk(self) -> None:
        self.conv1 = ConvBlock(3, 64, 2, kernel_size=7, use_bn=True)
        self.conv2 = ConvBlock(64, 128, 2, kernel_size=5, use_bn=True)
        self.conv3 = ConvBlock(128, 256, 2, kernel_size=5, use_bn=True)
        nk = (2 * self.DISPLACEMENT + 1) ** 2
        for name, cin, cout, k, s in TRUNK_CONVS:
            cin += nk if name == "conv3_1" else 0
            self.add_module(name, ConvBlock(cin, cout, s, kernel_size=k, use_bn=True))

    def trunk(self, x: torch.Tensor) -> dict[int, torch.Tensor]:
        """NHWC ``[B, H, W, 6]`` -> the NCHW skips by level."""
        im1 = x[..., :3].permute(0, 3, 1, 2).contiguous()
        im2 = x[..., 3:].permute(0, 3, 1, 2).contiguous()
        c2a = self.conv2(self.conv1(im1))
        c2b = self.conv2(self.conv1(im2))
        c3a, c3b = self.conv3(c2a), self.conv3(c2b)
        corr = F.leaky_relu(cost_volume(c3a, c3b, self.DISPLACEMENT), 0.1)
        c3 = self.conv3_1(torch.cat([self.conv_redir(c3a), corr], 1))
        c4 = self.conv4_1(self.conv4(c3))
        c5 = self.conv5_1(self.conv5(c4))
        return {2: c2a, 3: c3, 4: c4, 5: c5, 6: self.conv6_1(self.conv6(c5))}

    def forward(self, x):
        with full_fp32_convs(x.dtype):
            skips = self.trunk(x)
            cat = skips[6]
            for lvl in LEVELS[:-1]:
                heads = [getattr(self, f"predict_{h}{lvl}")(cat) for h in self.HEADS]
                ups = [getattr(self, f"upsampled_{h}{lvl}_to_{lvl - 1}")(t)
                       for h, t in zip(self.HEADS, heads)]
                d = getattr(self, f"deconv{lvl - 1}")(cat)
                cat = torch.cat([skips[lvl - 1], d, *ups], 1)
            outs = []
            for h in self.HEADS:
                t = getattr(self, f"predict_{h}{LEVELS[-1]}")(cat)
                hh, ww = t.shape[2] * 4, t.shape[3] * 4
                t = resize_bilinear(t, hh, ww, align_corners=False)
                outs.append(t.permute(0, 2, 3, 1).contiguous())
        return outs[0] if len(outs) == 1 else tuple(outs)


class FlowNetC(FlowNetCFamily):
    """FlowNetC (``ocflow_tpu/models/flow_net_s.py:FlowNetC``): the flow
    ``[B, H, W, 2]``. Serve it in eval mode (see :class:`FlowNetCFamily`)."""

    HEADS = ("flow",)


# FlowNetS's trunk after conv1 .. conv3 (name, cin, cout, stride), 3x3 each
S_TRUNK_CONVS = (("conv3_1", 256, 256, 1), ("conv4", 256, 512, 2), ("conv4_1", 512, 512, 1),
                 ("conv5", 512, 512, 2), ("conv5_1", 512, 512, 1), ("conv6", 512, 1024, 2),
                 ("conv6_1", 1024, 1024, 1))


class FlowNetSFamily(FlowNetCFamily):
    """The FlowNetS family (FlowNetS, OcclusionNetS, FlowOccNetS): the
    FlowNetC family's decoder and heads on the FlowNetS trunk, one encoder
    over the stacked frames (``ocflow_tpu/models/occlusion_nets.py:
    _FNetSEncoder``): conv1 7x7/s2, conv2 5x5/s2, conv3 5x5/s2 on the 6
    channels, then conv3_1 .. conv6_1 (stride 2 at conv4, conv5, conv6), a
    ``ConvBlock`` with BatchNorm each. No cost volume: these nets launch no
    kernel of this repository.

    The heads' up-deconvs (``upsampled_<head><k>_to_<k-1>``) have a bias,
    as the JAX modules' ``Deconv(act=False)`` has and trains; the reference
    torch networks build them without one, so the JAX package's converters
    (``convert_flownets``, ``convert_occlusion_net_s``,
    ``convert_flow_occ_net_s``) read a ``state_dict`` without those biases
    and give them zeros."""

    def _build_trunk(self) -> None:
        self.conv1 = ConvBlock(6, 64, 2, kernel_size=7, use_bn=True)
        self.conv2 = ConvBlock(64, 128, 2, kernel_size=5, use_bn=True)
        self.conv3 = ConvBlock(128, 256, 2, kernel_size=5, use_bn=True)
        for name, cin, cout, s in S_TRUNK_CONVS:
            self.add_module(name, ConvBlock(cin, cout, s, use_bn=True))

    def trunk(self, x: torch.Tensor) -> dict[int, torch.Tensor]:
        """NHWC ``[B, H, W, 6]`` -> the NCHW skips by level."""
        c2 = self.conv2(self.conv1(x.permute(0, 3, 1, 2).contiguous()))
        c3 = self.conv3_1(self.conv3(c2))
        c4 = self.conv4_1(self.conv4(c3))
        c5 = self.conv5_1(self.conv5(c4))
        return {2: c2, 3: c3, 4: c4, 5: c5, 6: self.conv6_1(self.conv6(c5))}


class FlowNetS(FlowNetSFamily):
    """FlowNetS (``ocflow_tpu/models/flow_net_s.py:FlowNetS``): the flow
    ``[B, H, W, 2]`` from ``[B, H, W, 6]`` (H and W divisible by 64). Serve
    it in eval mode (see :class:`FlowNetCFamily`)."""

    HEADS = ("flow",)
