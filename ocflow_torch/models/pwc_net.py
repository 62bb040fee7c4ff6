"""FlowNetCV and PWCNet, eager (port of ``ocflow_tpu/models/pwc_net.py``).

6-level siamese feature pyramid (16/32/64/96/128/196); at each level a warp
by the upsampled flow (scales 0.625/1.25/2.5/5.0), UFlow feature
normalization, an 81-channel cost volume and a DenseNet decoder
(128/128/96/64/32, concat growth NEWEST first); a dilated context network;
output ``(4x-upsampled flow2 * 20, flow2 * 5)``.

The modules compute in NCHW with PyTorch ops (cuDNN convs) and the cost
volume of ``ocflow_torch.kernels.cost_volume``, called through this
module's name ``cost_volume``: the hand-written kernel for CUDA tensors
(its backward kernel under autograd), the plain version for CPU tensors,
as the JAX module takes ``cost_volume_fused``. This is the yardstick the
fused serving path (``models.pwc_fast.fast_apply``) is held against; a
check that must not depend on the kernel swaps the name for
``cost_volume_plain``. ``forward`` takes ``[B, H, W, 6]`` and returns NHWC
flows, like the JAX module.

Parameter names are the reference torch network's (``conv1a.0``,
``conv6aa.0``, ``conv6_0.0``, ``predict_flow6``, ``deconv6``, ``upfeat6``,
``dc_conv1.0`` ... ``dc_conv7``): ``FlowNetCV`` registers the layers of its
``SiameseEncoder``, ``DenseDecoder``s and ``ContextNetwork`` under those
flat names and calls them through the three sub-modules.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ocflow_torch.kernels.cost_volume import cost_volume
from ocflow_torch.models.common import ConvBlock, Deconv, PredictFlow, init_weights
from ocflow_torch.ops.cost_volume import normalize_features
from ocflow_torch.ops.resize import resize_bilinear
from ocflow_torch.ops.warp import warp

LEVEL_FEATURES = (16, 32, 64, 96, 128, 196)
GROWTH = (128, 128, 96, 64, 32)
CONTEXT = ((128, 1), (128, 2), (128, 4), (96, 8), (64, 16), (32, 1))
DECODER_LEVELS = (6, 5, 4, 3, 2)  # reference level names, coarse to fine


def encoder_names() -> list[str]:
    """Reference names of the 18 encoder convs, level-major; the coarsest
    level declares its stride-2 conv as ``conv6aa``."""
    names = []
    for lvl in range(1, 6):
        names += [f"conv{lvl}a", f"conv{lvl}aa", f"conv{lvl}b"]
    return names + ["conv6aa", "conv6a", "conv6b"]


def _leaky(x):
    return F.leaky_relu(x, 0.1)


class SiameseEncoder(nn.Module):
    """Three 3x3 convs per level, the first with stride 2."""

    def __init__(self, device=None, dtype=None):
        super().__init__()
        names = encoder_names()
        cin = 3
        for lvl, c in enumerate(LEVEL_FEATURES):
            for j in range(3):
                self.add_module(names[3 * lvl + j], ConvBlock(
                    cin, c, stride=2 if j == 0 else 1, device=device,
                    dtype=dtype))
                cin = c

    def levels(self) -> list[list[nn.Conv2d]]:
        convs = [block[0] for block in self.children()]
        return [convs[3 * i:3 * i + 3] for i in range(len(LEVEL_FEATURES))]

    def forward(self, x):
        feats = []
        blocks = list(self.children())
        for lvl in range(len(LEVEL_FEATURES)):
            for block in blocks[3 * lvl:3 * lvl + 3]:
                x = block(x)
            feats.append(x)
        return feats


class DenseDecoder(nn.Module):
    """``x <- cat(conv_j(x), x)`` five times (newest first), then the flow
    head; returns ``(flow, features)``."""

    def __init__(self, level: int, cin: int, device=None, dtype=None):
        super().__init__()
        self.level = level
        c = cin
        for j, g in enumerate(GROWTH):
            self.add_module(f"conv{level}_{j}", ConvBlock(
                c, g, device=device, dtype=dtype))
            c += g
        self.add_module(f"predict_flow{level}", PredictFlow(
            c, device=device, dtype=dtype))

    def convs(self) -> list[nn.Conv2d]:
        """The five growth convs, then the flow head."""
        return [getattr(self, f"conv{self.level}_{j}")[0]
                for j in range(len(GROWTH))] + [
                    getattr(self, f"predict_flow{self.level}")]

    def forward(self, x):
        for j in range(len(GROWTH)):
            x = torch.cat([getattr(self, f"conv{self.level}_{j}")(x), x], 1)
        return getattr(self, f"predict_flow{self.level}")(x), x


class ContextNetwork(nn.Module):
    """Dilated refinement ``dc_conv1..6`` plus the flow head ``dc_conv7``."""

    def __init__(self, cin: int, device=None, dtype=None):
        super().__init__()
        c = cin
        for j, (g, d) in enumerate(CONTEXT):
            self.add_module(f"dc_conv{j + 1}", ConvBlock(
                c, g, dilation=d, device=device, dtype=dtype))
            c = g
        self.add_module(f"dc_conv{len(CONTEXT) + 1}", PredictFlow(
            c, device=device, dtype=dtype))

    def convs(self) -> list[nn.Conv2d]:
        """dc_conv1..6, then the flow head dc_conv7."""
        return [getattr(self, f"dc_conv{j + 1}")[0]
                for j in range(len(CONTEXT))] + [
                    getattr(self, f"dc_conv{len(CONTEXT) + 1}")]

    def forward(self, x):
        for j in range(len(CONTEXT) + 1):
            x = getattr(self, f"dc_conv{j + 1}")(x)
        return x


class FlowNetCV(nn.Module):
    """The flagship flow model. ``forward`` takes ``[B, H, W, 6]`` (two
    frames on channels, H and W divisible by 64) and returns
    ``(flow_full [B, H, W, 2], flow_quarter [B, H/4, W/4, 2])`` in fp32.

    ``generator`` seeds the init (:func:`models.common.init_weights`);
    without it the layers keep PyTorch's default init.
    """

    def __init__(self, displacement: int = 4,
                 warp_scales: Sequence[float] = (0.625, 1.25, 2.5, 5.0),
                 normalize: bool = True, warp_align_corners: bool = False,
                 device=None, dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.displacement = displacement
        self.warp_scales = tuple(warp_scales)
        self.normalize = normalize
        self.warp_align_corners = warp_align_corners
        kw = dict(device=device, dtype=dtype)
        nk = (2 * displacement + 1) ** 2
        encoder = SiameseEncoder(**kw)
        decoders = []
        for lvl in DECODER_LEVELS:
            cin = nk if lvl == 6 else nk + LEVEL_FEATURES[lvl - 1] + 4
            decoders.append(DenseDecoder(lvl, cin, **kw))
        context = ContextNetwork(
            nk + LEVEL_FEATURES[1] + 4 + sum(GROWTH), **kw)
        for part in (encoder, *decoders, context):
            for name, m in part.named_children():
                self.add_module(name, m)
        for lvl, dec in zip(DECODER_LEVELS[:-1], decoders):
            self.add_module(f"deconv{lvl}", Deconv(2, **kw))
            self.add_module(f"upfeat{lvl}", Deconv(
                dec.convs()[-1].in_channels, **kw))
        # the sub-modules share the layers registered above; kept out of
        # the module tree so the state_dict keys stay flat
        self.__dict__["encoder"] = encoder
        self.__dict__["decoders"] = tuple(decoders)
        self.__dict__["context"] = context
        if generator is not None:
            init_weights(self, generator)

    def upsamplers(self, level: int) -> tuple[nn.ConvTranspose2d, nn.ConvTranspose2d]:
        """``(deconv, upfeat)`` of a decoder level (6..3)."""
        return getattr(self, f"deconv{level}"), getattr(self, f"upfeat{level}")

    def forward(self, x):
        b = x.shape[0]
        img = torch.cat([x[..., :3], x[..., 3:]], 0).permute(0, 3, 1, 2)
        both = self.encoder(img.contiguous())
        f1 = [f[:b] for f in both]
        f2 = [f[b:] for f in both]
        d = self.displacement

        c16, c26 = f1[5], f2[5]
        if self.normalize:
            c16, c26 = normalize_features([c16, c26])
        corr = _leaky(cost_volume(c16, c26, d))
        flow, feat = self.decoders[0](corr)
        deconv, upfeat = self.upsamplers(6)
        up_flow, up_feat = deconv(flow), upfeat(feat)

        flow2 = feat2 = None
        for i, (lvl, scale) in enumerate(zip((4, 3, 2, 1), self.warp_scales)):
            warped = warp(f2[lvl], up_flow * scale,
                          align_corners=self.warp_align_corners)
            c1n, wn = f1[lvl], warped
            if self.normalize:
                c1n, wn = normalize_features([c1n, wn])
            corr = _leaky(cost_volume(c1n, wn, d))
            # the decoder reads the NORMALIZED level features
            xcat = torch.cat([corr, c1n, up_flow, up_feat], 1)
            flow, feat = self.decoders[i + 1](xcat)
            if lvl > 1:
                deconv, upfeat = self.upsamplers(lvl + 1)
                up_flow, up_feat = deconv(flow), upfeat(feat)
            else:
                flow2, feat2 = flow, feat

        flow2 = (flow2 + self.context(feat2)).float()
        h, w = flow2.shape[2] * 4, flow2.shape[3] * 4
        flow1 = resize_bilinear(flow2, h, w, align_corners=True) * 20.0
        return (flow1.permute(0, 2, 3, 1).contiguous(),
                (flow2 * 5.0).permute(0, 2, 3, 1).contiguous())


class PWCNet(FlowNetCV):
    """sniklaus-style PWC-Net: FlowNetCV's structure with raw (un-normalized)
    correlation and align_corners=True warping."""

    def __init__(self, **kw):
        kw.setdefault("normalize", False)
        kw.setdefault("warp_align_corners", True)
        super().__init__(**kw)
