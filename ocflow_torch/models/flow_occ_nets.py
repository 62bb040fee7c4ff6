"""Joint flow + occlusion nets, eager (port of
``ocflow_tpu/models/flow_occ_nets.py``): ``SimpleFlowOccNet`` (``simple``),
``FlowOccNetS`` (``flowoccnets``, the FlowNetS trunk), ``FlowOccNetC``
(``flowoccnetc``, the FlowNetC trunk, d=10), ``FlowOccNetCV`` (``pwoc``),
``FlowOccNetCV2`` (``pwoc2``) and ``FlowOccNet`` (``flowoccnet``), each
``[B, H, W, 6]`` -> ``(flow [B, H, W, 2], occ [B, H, W, 1])`` with
occlusion probabilities in [0, 1] (SimpleFlowOccNet's hardened to 0 or 1
by a straight-through estimator). ``simple`` and ``flowoccnets`` have no
cost volume and launch no kernel of this repository.

``pwoc`` and ``pwoc2`` are FlowNetCV's structure (its ``SiameseEncoder``,
``Deconv`` upsamplers, dilated ``ContextNetwork``) with a flow and an
occlusion head per level. Unlike FlowNetCV they do not normalize the
features, and frame 2's warped features are gated by the upsampled
occlusion before the correlation (``occlusion_gated_cost_volume``), so the
gradient reaches the gate through ``warped * occ``. ``pwoc2`` has two
separate conv towers per level (``fe*`` for the flow, ``oe*`` for the
occlusion). ``flowoccnet`` is the FPN net of ``models.flow_net`` with an
``OcclusionEstimator`` per level whose output gates the warped features.

The cost volumes (d=4 here, d=10 in the FlowNetC trunk) run
``ocflow_torch.kernels.cost_volume.cost_volume`` through this module's
name ``cost_volume`` (pwoc, pwoc2, flowoccnet) or ``flow_net_s``'s
(FlowOccNetC): the hand-written kernels for CUDA tensors, the plain version
for CPU tensors. Serve ``flowoccnet`` and FlowOccNetC in eval mode (they
have BatchNorm).

Parameter names are the reference torch networks' (``down1.conv1``,
``predict_flow5.0.0``, ``predict_occ5.0.0``, ``up1.conv1`` in ``simple``;
``conv1a.0``,
``conv6_0.0``, ``predict_flow6``, ``predict_occ6.0``, ``upflow6``,
``upocc6``, ``upfeat6``, ``dc_conv1.0`` ... ``dc_conv7``; ``fe6_0.0``,
``oe6_0.0`` in pwoc2; FlowOccNetC's ``conv1.0`` ..., ``upsampled_occ6_to_5``
...), which ``convert_flow_occ_net_cv``, ``convert_flow_occ_net_cv2``,
``convert_flow_occ_net_fpn``, ``convert_flow_occ_net_c``,
``convert_simple_flow_occ_net`` and ``convert_flow_occ_net_s`` of the JAX
package map onto its flax trees (FlowOccNetS's up-deconv biases aside:
:class:`~ocflow_torch.models.flow_net_s.FlowNetSFamily`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ocflow_torch import full_fp32_convs
from ocflow_torch.kernels.cost_volume import cost_volume
from ocflow_torch.models.common import (ConvBlock, Deconv, PredictFlow, PredictFlowStack,
                                        PredictOcc, PredictOccStack, ProjDown, ProjUp,
                                        init_weights)
from ocflow_torch.models.feature_pyramid import (ContextNetwork as FPNContextNetwork,
                                                 FeaturePyramidNet, OcclusionEstimator,
                                                 OpticalFlowEstimator)
from ocflow_torch.models.flow_net import PYRAMID, frames, upsample4
from ocflow_torch.models.flow_net_s import FlowNetCFamily, FlowNetSFamily
from ocflow_torch.models.pwc_net import (DECODER_LEVELS, GROWTH, LEVEL_FEATURES,
                                         ContextNetwork, SiameseEncoder)
from ocflow_torch.models.simple_flow_net import DOWN, UP
from ocflow_torch.ops.resize import resize_bilinear
from ocflow_torch.ops.ste import hard_threshold_ste
from ocflow_torch.ops.warp import warp


class FlowOccNetC(FlowNetCFamily):
    """``(flow [B, H, W, 2], occ [B, H, W, 1])`` from ``[B, H, W, 6]`` (port
    of ``ocflow_tpu/models/flow_occ_nets.py:FlowOccNetC``): the FlowNetC
    trunk (d=10 cost volume) and dual heads per level, in the order
    ``PredictFlow``, ``PredictOcc``, flow up-deconv, occlusion up-deconv,
    feature deconv; each level reads ``cat([skip, deconv, flow_up,
    occ_up])``. Serve it in eval mode (``model.eval()``): in train mode
    BatchNorm uses the batch's statistics (see
    :class:`~ocflow_torch.models.flow_net_s.FlowNetCFamily`)."""

    HEADS = ("flow", "occ")


class FlowOccNetS(FlowNetSFamily):
    """The FlowNetS trunk with dual heads (port of ``ocflow_tpu/models/
    flow_occ_nets.py:FlowOccNetS``), the decoder order of
    :class:`FlowOccNetC`."""

    HEADS = ("flow", "occ")


class SimpleFlowOccNet(nn.Module):
    """SimpleFlowNet's U-Net with a flow and an occlusion head per decoder
    level (port of ``ocflow_tpu/models/flow_occ_nets.py:SimpleFlowOccNet``):
    ``down1..down5``; per level 5..2 ``predict_flow<k>`` and
    ``predict_occ<k>`` on the features, then ``up<i>`` on ``cat([x, flow,
    occ])`` with the skip (``up1..up4``: 96, 64, 32, 16 channels); at the
    1/2 level ``predict_flow1`` and the logit head ``predict_occ1``. The
    flow and the logit are resized to the input (bilinear,
    ``align_corners=False``); the occlusion is ``sigmoid(10 logit)``
    hardened by :func:`~ocflow_torch.ops.ste.hard_threshold_ste`. H and W
    divisible by 32. ``generator`` seeds the init."""

    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        skips, cin = [6], 6
        for i, (c, ratio) in enumerate(DOWN, 1):
            self.add_module(f"down{i}", ProjDown(cin, c, ratio))
            skips.append(c)
            cin = c
        for i, c in enumerate(UP[:-1], 1):
            self.add_module(f"predict_flow{6 - i}", PredictFlowStack(cin))
            self.add_module(f"predict_occ{6 - i}", PredictOccStack(cin))
            self.add_module(f"up{i}", ProjUp(skips[-1 - i] + cin + 3, c))
            cin = c
        self.predict_flow1 = PredictFlowStack(cin)
        self.predict_occ1 = PredictOccStack(cin, sigmoid=False)
        if generator is not None:
            init_weights(self, generator)

    def forward(self, x):
        with full_fp32_convs(x.dtype):
            skips = [x.permute(0, 3, 1, 2).contiguous()]
            for i in range(1, len(DOWN) + 1):
                skips.append(getattr(self, f"down{i}")(skips[-1]))
            h = skips[-1]
            for i in range(1, len(UP)):
                flow = getattr(self, f"predict_flow{6 - i}")(h)
                occ = getattr(self, f"predict_occ{6 - i}")(h)
                h = getattr(self, f"up{i}")(torch.cat([h, flow, occ], 1), skips[-1 - i])
            flow, logit = self.predict_flow1(h), self.predict_occ1(h)
        hh, ww = x.shape[1], x.shape[2]
        flow = resize_bilinear(flow, hh, ww, align_corners=False)
        occ = hard_threshold_ste(torch.sigmoid(
            10.0 * resize_bilinear(logit, hh, ww, align_corners=False)))
        return flow.permute(0, 2, 3, 1).contiguous(), occ.permute(0, 2, 3, 1).contiguous()


def occlusion_gated_cost_volume(f1: torch.Tensor, warped: torch.Tensor, occ: torch.Tensor,
                                displacement: int) -> torch.Tensor:
    """LeakyReLU(0.1) of the cost volume of ``f1`` and ``warped * occ``:
    the warped frame-2 features gated by the upsampled occlusion estimate,
    a multiplicative confidence in [0, 1], before the correlation."""
    return F.leaky_relu(cost_volume(f1, warped * occ, displacement), 0.1)


def _tower(module: nn.Module, prefix: str, cin: int) -> int:
    """Register the five concat-growth convs ``{prefix}_{j}`` on
    ``module``; returns the channels after them."""
    for j, g in enumerate(GROWTH):
        module.add_module(f"{prefix}_{j}", ConvBlock(cin, g))
        cin += g
    return cin


def _grow(module: nn.Module, prefix: str, x: torch.Tensor) -> torch.Tensor:
    for j in range(len(GROWTH)):
        x = torch.cat([getattr(module, f"{prefix}_{j}")(x), x], 1)
    return x


class FlowOccNetCV(nn.Module):
    """The PWC-style joint net (``pwoc``): per level a dense decoder
    ``conv<l>_0..4`` (concat growth, newest first) with the heads
    ``predict_flow<l>`` and ``predict_occ<l>``; ``upflow<l>``, ``upocc<l>``,
    ``upfeat<l>`` (the features to 2 channels) upsample them for the next
    level. ``generator`` seeds the init."""

    SEPARATE = False

    def __init__(self, displacement: int = 4,
                 warp_scales: Sequence[float] = (0.625, 1.25, 2.5, 5.0),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.displacement = displacement
        self.warp_scales = tuple(warp_scales)
        nk = (2 * displacement + 1) ** 2
        encoder = SiameseEncoder()
        for name, m in encoder.named_children():
            self.add_module(name, m)
        self.__dict__["encoder"] = encoder  # its layers are registered flat above
        for lvl in DECODER_LEVELS:
            cin = nk if lvl == 6 else nk + LEVEL_FEATURES[lvl - 1] + 5
            if self.SEPARATE:
                cf = _tower(self, f"fe{lvl}", cin)
                self.add_module(f"predict_flow{lvl}", PredictFlow(cf))
                self.add_module(f"predict_occ{lvl}", PredictOcc(_tower(self, f"oe{lvl}", cin)))
            else:
                cf = _tower(self, f"conv{lvl}", cin)
                self.add_module(f"predict_flow{lvl}", PredictFlow(cf))
                self.add_module(f"predict_occ{lvl}", PredictOcc(cf))
            if lvl > DECODER_LEVELS[-1]:
                self.add_module(f"upflow{lvl}", Deconv(2, 2))
                self.add_module(f"upocc{lvl}", Deconv(1, 1))
                self.add_module(f"upfeat{lvl}", Deconv(cf, 2))
        context = ContextNetwork(cf)
        for name, m in context.named_children():
            self.add_module(name, m)
        self.__dict__["context"] = context
        if generator is not None:
            init_weights(self, generator)

    def decode(self, lvl: int, x: torch.Tensor):
        """Level ``lvl``'s ``(flow, occ, flow-tower features)``."""
        if self.SEPARATE:
            fx, ox = _grow(self, f"fe{lvl}", x), _grow(self, f"oe{lvl}", x)
        else:
            fx = ox = _grow(self, f"conv{lvl}", x)
        return (getattr(self, f"predict_flow{lvl}")(fx),
                getattr(self, f"predict_occ{lvl}")(ox), fx)

    def upsample(self, lvl: int, flow, occ, feat):
        return (getattr(self, f"upflow{lvl}")(flow), getattr(self, f"upocc{lvl}")(occ),
                getattr(self, f"upfeat{lvl}")(feat))

    def forward(self, x):
        with full_fp32_convs(x.dtype):
            b = x.shape[0]
            img = torch.cat([x[..., :3], x[..., 3:]], 0).permute(0, 3, 1, 2)
            both = self.encoder(img.contiguous())
            f1 = [f[:b] for f in both]
            f2 = [f[b:] for f in both]
            d = self.displacement
            corr = F.leaky_relu(cost_volume(f1[5], f2[5], d), 0.1)
            flow, occ, feat = self.decode(6, corr)
            up_flow, up_occ, up_feat = self.upsample(6, flow, occ, feat)
            for lvl, scale in zip((4, 3, 2, 1), self.warp_scales):
                warped = warp(f2[lvl], up_flow * scale, align_corners=False)
                corr = occlusion_gated_cost_volume(f1[lvl], warped, up_occ, d)
                xcat = torch.cat([corr, f1[lvl], up_flow, up_occ, up_feat], 1)
                flow, occ, feat = self.decode(lvl + 1, xcat)
                if lvl > 1:
                    up_flow, up_occ, up_feat = self.upsample(lvl + 1, flow, occ, feat)
            flow = flow + self.context(feat)
            return upsample4(flow), upsample4(occ)


class FlowOccNetCV2(FlowOccNetCV):
    """``FlowOccNetCV`` with separate flow and occlusion towers per level
    (``pwoc2``): ``fe<l>_0..4`` + ``predict_flow<l>`` and ``oe<l>_0..4`` +
    ``predict_occ<l>``, each reading the level's input; the flow tower's
    features feed ``upfeat<l>`` and the context network."""

    SEPARATE = True


class FlowOccNet(nn.Module):
    """The FPN joint net (``flowoccnet``): ``models.flow_net.FlowNet`` with
    an ``OcclusionEstimator`` per level on ``cat([f1, warped, occ_feat_up,
    occ_up])``; its occlusion (``sigmoid(10 x)`` at level 2) gates the
    warped features before the d=4 cost volume. ``generator`` seeds the
    init. Serve it in eval mode: the pyramid has BatchNorm."""

    def __init__(self, displacement: int = 4, generator: torch.Generator | None = None):
        super().__init__()
        self.displacement = displacement
        nk = (2 * displacement + 1) ** 2
        self.feature_pyramid_network = FeaturePyramidNet()
        self.occlusion_estimators = nn.ModuleList(
            OcclusionEstimator(2 * c + (2 if i else 0), highest_resolution=i == 4)
            for i, c in enumerate(PYRAMID))
        self.opticalflow_estimators = nn.ModuleList(
            OpticalFlowEstimator(nk + c + (4 if i else 0), highest_resolution=i == 4)
            for i, c in enumerate(PYRAMID))
        self.context_network = FPNContextNetwork(32 + 2)
        if generator is not None:
            init_weights(self, generator)

    def forward(self, x):
        with full_fp32_convs(x.dtype):
            im1, im2 = frames(x)
            pyr1 = self.feature_pyramid_network(im1)
            pyr2 = self.feature_pyramid_network(im2)
            flow_up = feat_up = occ_up = occ_feat_up = None
            levels = zip(pyr1, pyr2, self.occlusion_estimators, self.opticalflow_estimators)
            for i, (f1, f2, occ_est, est) in enumerate(levels):
                level = 6 - i
                warped = f2 if i == 0 else warp(f2, flow_up * (20.0 / 2.0 ** level),
                                                align_corners=False)
                occ_in = [f1, warped] + ([occ_feat_up, occ_up] if i else [])
                if level == 2:
                    occ = occ_est(torch.cat(occ_in, 1))
                else:
                    occ, occ_up, occ_feat_up = occ_est(torch.cat(occ_in, 1))
                inputs = [cost_volume(f1, warped * occ, self.displacement), f1]
                if i:
                    inputs += [flow_up, feat_up]
                if level == 2:
                    flow, feat = est(torch.cat(inputs, 1))
                else:
                    flow, flow_up, feat_up = est(torch.cat(inputs, 1))
            flow = flow + self.context_network(torch.cat([feat, flow], 1))
            return upsample4(flow), upsample4(occ)
