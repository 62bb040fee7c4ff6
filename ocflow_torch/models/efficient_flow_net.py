"""ENet-style efficient flow nets, eager (port of
``ocflow_tpu/models/efficient_flow_net.py``): ``EFlowNet`` (``eflownet``)
and ``EFlowNet2`` (``eflownet2``), each ``[B, H, W, 6]`` -> the flow
``[B, H, W, 2]`` (H and W divisible by 8). No cost volume: these nets
launch no kernel of this repository.

The encoder (``initial``, ``bottleneck10`` ... ``bottleneck38``) is
ENet's: an initial block (a 3x3/s2 conv beside a 2x2 max pool, BatchNorm, a
per-channel PReLU), a downsampling bottleneck to 64 channels and four
plain ones, a downsampling bottleneck to 128 and two rounds of eight
(plain, dilated 2, asymmetric 5x1/1x5, dilated 4, plain, dilated 8,
asymmetric, dilated 16). The decoder (``bottleneck40`` ... ``bottleneck51``)
unpools with the encoder's argmax indices (``ops.pooling``, dense as in the
JAX op) and uses ReLU; the flow comes out at 1/2 resolution and is resized
2x (bilinear, ``align_corners=False``). EFlowNet2 also predicts the flow
at 1/8 and 1/4 (``predict_flow3``, ``predict_flow4``) and feeds each back
into the decoder.

What the JAX modules fix, and the port keeps:

- two PReLU kinds with two inits: the initial block's is per channel,
  initialised to 0.25 (``ChannelPReLU``); a bottleneck's are flax
  ``nn.PReLU()``, one scalar slope each, initialised to 0.01 (flax's
  default, not torch's 0.25), and every application is a slope of its own
  (``prelu1``, ``prelu2``, ``prelu3``, ``prelu_out``, and ``conv2.2``
  inside an asymmetric block);
- the upsampling transposed conv is k3/s2 with flax padding ``((1, 2),
  (1, 2))``, torch's ``ConvTranspose2d(3, stride=2, padding=1,
  output_padding=1)``, then cropped to the unpooled size;
- the identity branch is zero-padded in channels after it; the bottleneck
  branch is zero-padded at the top and the left when its size differs from
  the identity's (a downsample of an odd size);
- ``Dropout2d`` (whole channels, flax's ``Dropout(broadcast_dims=(1, 2))``)
  acts only in train mode. The JAX training steps pass no dropout rng, so
  the JAX package cannot train these nets, and the port's training CLIs
  refuse them; serving is eval mode, where dropout is the identity.

Every BatchNorm is ``models.common.BatchNorm``: serve the nets in eval
mode. Parameter names are the reference torch network's
(``initial.conv``, ``initial.bn``, ``initial.prelu``, ``bottleneck10.conv1``,
``.bn1``, ``.prelu1``, ..., ``bottleneck40.spatil_conv``, ``.bn_up``,
``predict_flow``; ``predict_flow3`` .. ``predict_flow5`` in EFlowNet2),
which ``convert_eflownet`` and ``convert_eflownet2`` of the JAX package map
onto its flax trees.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ocflow_torch import full_fp32_convs
from ocflow_torch.models.common import BatchNorm, PredictFlow, init_weights
from ocflow_torch.ops.pooling import max_pool_2x2, max_pool_2x2_with_argmax, max_unpool_2x2
from ocflow_torch.ops.resize import resize_bilinear

# flax nn.PReLU's default slope (torch's nn.PReLU starts at 0.25)
FLAX_PRELU_INIT = 0.01


def _prelu() -> nn.PReLU:
    """One scalar slope, flax ``nn.PReLU()``'s init."""
    return nn.PReLU(1, init=FLAX_PRELU_INIT)


class InitialBlock(nn.Module):
    """``cat(maxpool(x), conv_s2(x))`` -> BatchNorm -> per-channel PReLU,
    16 channels out (``conv``: 3x3/s2 to ``16 - cin``)."""

    def __init__(self, cin: int = 6):
        super().__init__()
        self.conv = nn.Conv2d(cin, 16 - cin, 3, stride=2, padding=1)
        self.bn = BatchNorm(16)
        self.prelu = nn.PReLU(16, init=0.25)

    def forward(self, x):
        return self.prelu(self.bn(torch.cat([max_pool_2x2(x), self.conv(x)], 1)))


class BottleNeck(nn.Module):
    """The ENet bottleneck (``ocflow_tpu/models/efficient_flow_net.py:
    BottleNeck``): a main branch (the identity; a 2x2 max pool with its
    argmax when ``downsample``; a 1x1 conv, BatchNorm and the max-unpool when
    ``upsample``), zero-padded in channels to ``cout``, plus the projected
    branch: ``conv1`` (1x1, or 2x2/s2 when downsampling) to ``cin // 4``,
    ``conv2`` (3x3 dilated, the 1x5 + 5x1 pair when ``asymmetric``, the
    k3/s2 transposed conv when upsampling), ``conv3`` 1x1 to ``cout``, each
    with BatchNorm and the activation, then dropout; the sum through the
    activation. The activation is a fresh scalar PReLU at each use, or ReLU
    without ``use_prelu``."""

    def __init__(self, cin: int, cout: int | None = None, dilation: int = 1,
                 downsample: bool = False, upsample: bool = False, asymmetric: bool = False,
                 proj_ratio: int = 4, p_drop: float = 0.1, use_prelu: bool = True):
        super().__init__()
        self.cout = cout or cin
        self.downsample, self.upsample, self.use_prelu = downsample, upsample, use_prelu
        inter = cin // proj_ratio
        if upsample:
            self.spatil_conv = nn.Conv2d(cin, self.cout, 1, bias=False)
            self.bn_up = BatchNorm(self.cout)
        k1 = 2 if downsample else 1
        self.conv1 = nn.Conv2d(cin, inter, k1, stride=k1, bias=False)
        self.bn1 = BatchNorm(inter)
        if use_prelu:
            self.prelu1 = _prelu()
        if asymmetric:
            self.conv2 = nn.Sequential(nn.Conv2d(inter, inter, (1, 5), padding=(0, 2)),
                                       BatchNorm(inter), _prelu(),
                                       nn.Conv2d(inter, inter, (5, 1), padding=(2, 0)))
        elif upsample:
            self.conv2 = nn.ConvTranspose2d(inter, inter, 3, stride=2, padding=1,
                                            output_padding=1, bias=False)
        else:
            self.conv2 = nn.Conv2d(inter, inter, 3, padding=dilation, dilation=dilation,
                                   bias=False)
        self.bn2 = BatchNorm(inter)
        if use_prelu:
            self.prelu2 = _prelu()
        self.conv3 = nn.Conv2d(inter, self.cout, 1, bias=False)
        self.bn3 = BatchNorm(self.cout)
        if use_prelu:
            self.prelu3 = _prelu()
            self.prelu_out = _prelu()
        self.dropout = nn.Dropout2d(p_drop)

    def _act(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, name)(x) if self.use_prelu else F.relu(x)

    def forward(self, x, indices=None, out_size=None):
        identity = x
        idx = None
        if self.upsample:
            identity = max_unpool_2x2(self.bn_up(self.spatil_conv(x)), indices, out_size)
        elif self.downsample:
            identity, idx = max_pool_2x2_with_argmax(x)
        if self.cout > identity.shape[1]:
            identity = F.pad(identity, (0, 0, 0, 0, 0, self.cout - identity.shape[1]))

        y = self._act("prelu1", self.bn1(self.conv1(x)))
        y = self.conv2(y)
        if self.upsample and out_size is not None:
            y = y[:, :, :out_size[0], :out_size[1]]
        y = self._act("prelu2", self.bn2(y))
        y = self.dropout(self._act("prelu3", self.bn3(self.conv3(y))))
        dy, dx = identity.shape[2] - y.shape[2], identity.shape[3] - y.shape[3]
        if dy or dx:
            y = F.pad(y, (dx, 0, dy, 0))
        out = self._act("prelu_out", y + identity)
        return (out, idx) if self.downsample else out


# the encoder's bottlenecks after bottleneck10 .. 14 and bottleneck20: two
# rounds (stages 2 and 3) of eight, (suffix, kwargs)
_ROUND = ((1, {}), (2, {"dilation": 2}), (3, {"asymmetric": True}), (4, {"dilation": 4}),
          (5, {}), (6, {"dilation": 8}), (7, {"asymmetric": True}), (8, {"dilation": 16}))


class _ENet(nn.Module):
    """The ENet encoder and the two-stage unpooling decoder shared by
    EFlowNet and EFlowNet2; ``FEEDBACK`` adds the 1/8 and 1/4 flow heads
    whose output is concatenated into the decoder."""

    FEEDBACK = False

    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        fb = 2 if self.FEEDBACK else 0
        self.initial = InitialBlock(6)
        self.bottleneck10 = BottleNeck(16, 64, downsample=True, p_drop=0.01)
        for i in range(1, 5):
            self.add_module(f"bottleneck1{i}", BottleNeck(64, p_drop=0.01))
        self.bottleneck20 = BottleNeck(64, 128, downsample=True)
        for stage in (2, 3):
            for i, kw in _ROUND:
                self.add_module(f"bottleneck{stage}{i}", BottleNeck(128, **kw))
        if self.FEEDBACK:
            self.predict_flow3 = PredictFlow(128)
        self.bottleneck40 = BottleNeck(128 + fb, 64, upsample=True, use_prelu=False)
        self.bottleneck41 = BottleNeck(64, use_prelu=False)
        self.bottleneck42 = BottleNeck(64, use_prelu=False)
        if self.FEEDBACK:
            self.predict_flow4 = PredictFlow(64)
        self.bottleneck50 = BottleNeck(64 + fb, 16, upsample=True, use_prelu=False)
        self.bottleneck51 = BottleNeck(16, use_prelu=False)
        if self.FEEDBACK:
            self.predict_flow5 = PredictFlow(16)
        else:
            self.predict_flow = PredictFlow(16)
        if generator is not None:
            init_weights(self, generator)

    def forward(self, x):
        with full_fp32_convs(x.dtype):
            x = self.initial(x.permute(0, 3, 1, 2).contiguous())
            sz1 = (x.shape[2], x.shape[3])
            x, idx1 = self.bottleneck10(x)
            for i in range(1, 5):
                x = getattr(self, f"bottleneck1{i}")(x)
            sz2 = (x.shape[2], x.shape[3])
            x, idx2 = self.bottleneck20(x)
            for stage in (2, 3):
                for i, _ in _ROUND:
                    x = getattr(self, f"bottleneck{stage}{i}")(x)
            if self.FEEDBACK:
                x = torch.cat([x, self.predict_flow3(x)], 1)
            x = self.bottleneck40(x, idx2, sz2)
            x = self.bottleneck42(self.bottleneck41(x))
            if self.FEEDBACK:
                x = torch.cat([x, self.predict_flow4(x)], 1)
            x = self.bottleneck51(self.bottleneck50(x, idx1, sz1))
            flow = (self.predict_flow5 if self.FEEDBACK else self.predict_flow)(x)
        flow = resize_bilinear(flow, flow.shape[2] * 2, flow.shape[3] * 2, align_corners=False)
        return flow.permute(0, 2, 3, 1).contiguous()


class EFlowNet(_ENet):
    """The plain ENet encoder-decoder (``ocflow_tpu/models/
    efficient_flow_net.py:EFlowNet``). Serve it in eval mode."""


class EFlowNet2(_ENet):
    """EFlowNet with the flow at 1/8 and 1/4 fed back into the decoder
    (``ocflow_tpu/models/efficient_flow_net.py:EFlowNet2``). Serve it in
    eval mode."""

    FEEDBACK = True
