"""Gated-convolution inpainting, SN-PatchGAN style (port of
``ocflow_tpu/models/gated_conv.py``), eager, NCHW inside.

- :class:`GatedConv`: ``act(BN(f(x))) * sigmoid(g(x))``, the feature tower
  ``f`` and the gate tower ``g`` either plain convs or projected ones
  (:class:`ProjConv`: 1x1 to ``max(cin // proj_ratio, 1)`` channels, kxk,
  1x1); :class:`GatedDeConv` is a nearest 2x resize and a gated conv.
- :class:`SelfAttention`: ``gamma * softmax(q k^T) v + x`` over every
  position (``ops.attention.spatial_self_attention``: blockwise above 4096
  tokens), ``gamma`` starting at zero.
- :class:`InpaintSANet` (projected towers) and :class:`InpaintSANetOrg`
  (plain towers, the hole filled with ones, both outputs clamped to [-1,
  1]): a coarse gated trunk, then a refine trunk, the self-attention and
  the refine upsampler. ``forward(imgs, masks)`` takes NHWC ``[B, H, W,
  3]`` and ``[B, H, W, 1]`` (1 = hole, H and W divisible by 4) and returns
  ``(coarse, refined)``, NHWC.
- :class:`InpaintSADiscriminator` (projected) and
  :class:`InpaintSADiscriminatorOrg` (plain): five spectral-norm convs of
  kernel 5 and stride 2, each followed by LeakyReLU(0.2), the output
  flattened in NHWC order.

Padding is the reference's ``get_pad`` (:func:`torch_pad`), which for a
kernel of 5 and a stride of 2 pads 1, so each discriminator map is ``in/2 -
1``: a 64x128 input ends at 1x3, a 32x64 one at 0 rows. Projected towers
have no bias and plain ones have one; a gated deconv's conv has one either
way; the discriminators' convs have one. Every gated conv ends in
:class:`~ocflow_torch.models.common.BatchNorm` (flax's train-mode update).

The spectral norm is flax's (:class:`SNConv2d`), not
``torch.nn.utils.spectral_norm``: one step of power iteration in every mode
from the stored ``u``, stored back with ``sigma`` only in train mode.
``remat=True`` recomputes each gated (de)conv's body in the backward pass
(``torch.utils.checkpoint``), its BatchNorms frozen during the recompute so
their running statistics move once a step. In fp32 every conv runs in full
fp32 (``full_fp32_convs``). The nets launch no kernel of this repository.
Parameter names are the reference torch networks' (``coarse_net.0.conv2d
.conv1``, ``coarse_net.12.conv2d`` for a deconv's gated conv, ``batch_norm``
under projected towers and ``batch_norm2d`` under plain ones,
``refine_attn.query_conv``, ``discriminator_net.0.conv2d``), which the JAX
package's ``convert_inpaint_sanet`` maps onto its flax tree.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ocflow_torch import full_fp32_convs
from ocflow_torch.models.common import BatchNorm, frozen_stats, init_weights
from ocflow_torch.ops.attention import spatial_self_attention

CNUM = 32
SN_EPS = 1e-12


def torch_pad(k: int, s: int, d: int = 1) -> int:
    """The reference's ``get_pad`` for sizes divisible by the stride:
    ``(d (k - 1) + 1 - s) // 2``, one for a kernel of 5 and a stride of 2."""
    return (d * (k - 1) + 1 - s) // 2


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + SN_EPS)


class SNConv2d(nn.Conv2d):
    """``Conv2d`` whose kernel is divided by its largest singular value,
    estimated as ``flax.linen.SpectralNorm`` (``n_steps=1``, ``epsilon``
    1e-12) estimates it: ``v = l2n(u W^T)``, ``u' = l2n(v W)``, ``sigma = v W
    u'^T`` with ``u`` and ``v`` held constant, ``l2n(x) = x rsqrt(sum(x^2) +
    eps)``, ``W`` the kernel as a (kh kw cin, cout) matrix (its rows are
    ordered otherwise here, which changes none of the three). The kernel is
    divided by ``sigma``, or by 1 where ``sigma`` is 0; the bias is not.
    The iteration runs in every mode from the buffer ``u`` [1, cout]; in
    train mode ``u'`` and ``sigma`` are stored in the buffers ``u`` and
    ``sigma`` (flax's ``update_stats``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        dd = dict(device=self.weight.device, dtype=self.weight.dtype)
        self.register_buffer("u", torch.randn(1, self.out_channels, **dd))
        self.register_buffer("sigma", torch.ones((), **dd))

    def normalized_weight(self) -> torch.Tensor:
        w = self.weight.reshape(self.out_channels, -1)  # W^T, rows permuted
        with torch.no_grad():
            v = _l2_normalize(self.u @ w)
            u = _l2_normalize(v @ w.t())
        sigma = ((v @ w.t()) @ u.t())[0, 0]
        if self.training:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        return self.weight / torch.where(sigma != 0, sigma, torch.ones_like(sigma))

    def forward(self, x):
        return self._conv_forward(x, self.normalized_weight(), self.bias)


def _conv(cin, cout, k, stride=1, dilation=1, bias=True, spectral_norm=False):
    cls = SNConv2d if spectral_norm else nn.Conv2d
    return cls(cin, cout, k, stride=stride, padding=torch_pad(k, stride, dilation),
               dilation=dilation, bias=bias)


class ProjConv(nn.Module):
    """1x1 conv to ``max(cin // proj_ratio, 1)`` channels, ``k`` x ``k``
    conv (stride, dilation), 1x1 conv to ``cout`` (``conv1..3``; the
    reference's ``Conv2dWithProj``)."""

    def __init__(self, cin, cout, k, stride=1, dilation=1, proj_ratio=4, bias=False,
                 spectral_norm=False):
        super().__init__()
        inter = max(cin // proj_ratio, 1)
        self.conv1 = _conv(cin, inter, 1, bias=bias, spectral_norm=spectral_norm)
        self.conv2 = _conv(inter, inter, k, stride, dilation, bias, spectral_norm)
        self.conv3 = _conv(inter, cout, 1, bias=bias, spectral_norm=spectral_norm)

    def forward(self, x):
        return self.conv3(self.conv2(self.conv1(x)))


def _remat(module: nn.Module, body, x: torch.Tensor) -> torch.Tensor:
    """``body(x)``, recomputed in the backward pass when ``module.remat``
    asks for it and autograd records; the recompute runs with ``module``'s
    BatchNorms frozen, so their statistics move only in the forward."""
    if not (module.remat and torch.is_grad_enabled()):
        return body(x)
    return checkpoint(body, x, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), frozen_stats(module)))


class GatedConv(nn.Module):
    """``act(BN(conv2d(x))) * sigmoid(mask_conv2d(x))``, the towers
    :class:`ProjConv` when ``projected`` (BatchNorm ``batch_norm``) or plain
    convs (``batch_norm2d``). ``activation``: ``leaky_relu`` (0.2),
    ``tanh`` or ``None``. ``bias``: ``None`` for the reference's default
    (plain towers biased, projected ones not)."""

    def __init__(self, cin, cout, k, stride=1, dilation=1, projected=True, proj_ratio=4,
                 activation: str | None = "leaky_relu", bias: bool | None = None,
                 remat: bool = False):
        super().__init__()
        bias = (not projected) if bias is None else bias
        if projected:
            self.conv2d = ProjConv(cin, cout, k, stride, dilation, proj_ratio, bias)
            self.mask_conv2d = ProjConv(cin, cout, k, stride, dilation, proj_ratio, bias)
            self.batch_norm = BatchNorm(cout)
        else:
            self.conv2d = _conv(cin, cout, k, stride, dilation, bias)
            self.mask_conv2d = _conv(cin, cout, k, stride, dilation, bias)
            self.batch_norm2d = BatchNorm(cout)
        self.projected, self.activation, self.remat = projected, activation, remat

    def body(self, x):
        feat = self.conv2d(x)
        feat = (self.batch_norm if self.projected else self.batch_norm2d)(feat)
        if self.activation == "leaky_relu":
            feat = F.leaky_relu(feat, 0.2)
        elif self.activation == "tanh":
            feat = torch.tanh(feat)
        return feat * torch.sigmoid(self.mask_conv2d(x))

    def forward(self, x):
        return _remat(self, self.body, x)


class GatedDeConv(nn.Module):
    """Nearest 2x resize, then a biased 3x3 :class:`GatedConv` (``conv2d``);
    ``remat`` recomputes both together."""

    def __init__(self, cin, cout, projected=True, remat=False):
        super().__init__()
        self.conv2d = GatedConv(cin, cout, 3, projected=projected, bias=True)
        self.remat = remat

    def body(self, x):
        return self.conv2d(x.repeat_interleave(2, 2).repeat_interleave(2, 3))

    def forward(self, x):
        return _remat(self, self.body, x)


class SelfAttention(nn.Module):
    """``gamma * attention(q, k, v) + x`` over the H*W positions of ``x``
    (NCHW), q and k 1x1 convs to c/8 channels, v a 1x1 conv to c, tokens in
    row-major order (``ops.attention.spatial_self_attention``: blockwise
    above ``block_threshold`` tokens when they are a multiple of
    ``block_size``); ``gamma`` [1] starts at 0."""

    def __init__(self, c: int, block_threshold: int = 4096, block_size: int = 1024):
        super().__init__()
        self.query_conv = nn.Conv2d(c, c // 8, 1)
        self.key_conv = nn.Conv2d(c, c // 8, 1)
        self.value_conv = nn.Conv2d(c, c, 1)
        self.gamma = nn.Parameter(torch.zeros(1))
        self.block_threshold, self.block_size = block_threshold, block_size

    def forward(self, x):
        b, c, h, w = x.shape
        q, k, v = (conv(x).flatten(2).transpose(1, 2)
                   for conv in (self.query_conv, self.key_conv, self.value_conv))
        out = spatial_self_attention(q, k, v, self.block_threshold, self.block_size)
        return self.gamma * out.transpose(1, 2).reshape(b, c, h, w) + x


# (cout / CNUM, kernel, stride, dilation, proj_ratio); None: a GatedDeConv
COARSE = ((1, 5, 1, 1, 1), (2, 4, 2, 1, 4), (2, 3, 1, 1, 4), (4, 4, 2, 1, 4),
          (4, 3, 1, 1, 4), (4, 3, 1, 1, 4), (4, 3, 1, 2, 4), (4, 3, 1, 4, 4),
          (4, 3, 1, 8, 4), (4, 3, 1, 16, 4), (4, 3, 1, 1, 4), (4, 3, 1, 1, 4),
          (2, None), (2, 3, 1, 1, 4), (1, None), (0.5, 3, 1, 1, 4), (None, 3, 1, 1, 4))
REFINE = ((1, 5, 1, 1, 1), (1, 4, 2, 1, 4), (2, 3, 1, 1, 4), (2, 4, 2, 1, 4),
          (4, 3, 1, 1, 4), (4, 3, 1, 1, 4), (4, 3, 1, 1, 4), (4, 3, 1, 2, 4),
          (4, 3, 1, 4, 4), (4, 3, 1, 8, 4), (4, 3, 1, 16, 4))
UPSAMPLE = ((4, 3, 1, 1, 4), (4, 3, 1, 1, 4), (2, None), (2, 3, 1, 1, 4), (1, None),
            (0.5, 3, 1, 1, 4), (None, 3, 1, 1, 4))
# the discriminators' widths, input first
DIS_WIDTHS = (4, 2 * CNUM, 4 * CNUM, 8 * CNUM, 8 * CNUM, 8 * CNUM)


def _trunk(spec, cin: int, projected: bool, remat: bool) -> nn.Sequential:
    """A ``Sequential`` of gated (de)convs; a ``None`` width is the 3-channel
    output layer (``tanh`` when projected, no activation otherwise)."""
    layers = []
    for width, *conv in spec:
        cout = 3 if width is None else int(width * CNUM)
        if conv == [None]:
            layers.append(GatedDeConv(cin, cout, projected, remat))
        else:
            k, s, d, ratio = conv
            act = ("tanh" if projected else None) if width is None else "leaky_relu"
            layers.append(GatedConv(cin, cout, k, s, d, projected, ratio, act, remat=remat))
        cin = cout
    return nn.Sequential(*layers)


def init_gated(module: nn.Module, generator: torch.Generator) -> None:
    """The seeded init: :func:`models.common.init_weights` (truncated
    LeCun-normal kernels, zero biases, identity BatchNorm; ``gamma`` stays
    0), then each spectral norm's ``u`` from a standard normal and its
    ``sigma`` 1, in module order."""
    init_weights(module, generator)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, SNConv2d):
                m.u.copy_(torch.randn(m.u.shape, generator=generator))
                m.sigma.fill_(1.0)


class InpaintSANet(nn.Module):
    """The gated-conv generator with self-attention in its refine branch
    (see the module docstring). ``projected``: projected towers (plain for
    :class:`InpaintSANetOrg`); ``remat``: recompute each gated block in the
    backward pass; ``generator`` seeds the init (:func:`init_gated`)."""

    org = False

    def __init__(self, projected: bool = True, remat: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.coarse_net = _trunk(COARSE, 4, projected, remat)
        self.refine_conv_net = _trunk(REFINE, 4, projected, remat)
        self.refine_attn = SelfAttention(4 * CNUM)
        self.refine_upsample_net = _trunk(UPSAMPLE, 4 * CNUM, projected, remat)
        if generator is not None:
            init_gated(self, generator)

    def forward(self, imgs: torch.Tensor, masks: torch.Tensor):
        with full_fp32_convs(imgs.dtype):
            imgs = imgs.permute(0, 3, 1, 2)
            masks = masks.permute(0, 3, 1, 2)
            kept = imgs * (1.0 - masks)
            masked = kept + masks if self.org else kept
            coarse = self.coarse_net(torch.cat([masked, masks], 1))
            if self.org:
                coarse = coarse.clamp(-1.0, 1.0)
            x = self.refine_conv_net(torch.cat([kept + coarse * masks, masks], 1))
            x = self.refine_upsample_net(self.refine_attn(x))
            if self.org:
                x = x.clamp(-1.0, 1.0)
        return coarse.permute(0, 2, 3, 1), x.permute(0, 2, 3, 1)


class InpaintSANetOrg(InpaintSANet):
    """The original DeepFillv2-style generator: plain gated convs, the hole
    filled with ones, ``coarse`` and ``refined`` clamped to [-1, 1]."""

    org = True

    def __init__(self, remat: bool = False, generator: torch.Generator | None = None):
        super().__init__(projected=False, remat=remat, generator=generator)


class _SNBlock(nn.Module):
    """A spectral-norm conv (``conv2d``: :class:`ProjConv` when projected)
    of kernel 5 and stride 2, then LeakyReLU(0.2)."""

    def __init__(self, cin: int, cout: int, projected: bool):
        super().__init__()
        if projected:
            self.conv2d = ProjConv(cin, cout, 5, 2, bias=True, spectral_norm=True)
        else:
            self.conv2d = _conv(cin, cout, 5, 2, spectral_norm=True)

    def forward(self, x):
        return F.leaky_relu(self.conv2d(x), 0.2)


class InpaintSADiscriminator(nn.Module):
    """SN-PatchGAN critic (see the module docstring): ``forward(x)`` on NHWC
    ``[B, H, W, 4]`` (image and mask) returns ``[B, h w 256]``, the last map
    flattened in NHWC order."""

    projected = True

    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        self.discriminator_net = nn.Sequential(*(
            _SNBlock(cin, cout, self.projected)
            for cin, cout in zip(DIS_WIDTHS, DIS_WIDTHS[1:])))
        if generator is not None:
            init_gated(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with full_fp32_convs(x.dtype):
            y = self.discriminator_net(x.permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)


class InpaintSADiscriminatorOrg(InpaintSADiscriminator):
    """:class:`InpaintSADiscriminator` with plain spectral-norm convs."""

    projected = False
