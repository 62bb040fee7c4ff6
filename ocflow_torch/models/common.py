"""Shared building blocks (port of ``ocflow_tpu/models/common.py`` and of
``PredictOcc`` in ``ocflow_tpu/models/occlusion_nets.py``), NCHW, and the
seeded init that draws from flax's default initializers.

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
  ``Sequential(Conv2d(cin, 1, 3, p1), Sigmoid)`` (keys ``<name>.0``);
  ``PredictFlowStack`` is ``Sequential(ConvBlock(32), ConvBlock(16),
  Sequential(Conv2d(16, 2)))`` (keys ``<name>.0.0``, ``.1.0``, ``.2.0``);
- ``ProjDown`` / ``ProjUp`` are the projection-bottleneck blocks of
  SimpleFlowNet and InpaintingNet: three ``conv<k>`` (no bias) / ``bn<k>``
  pairs (InpaintingNet's last up block: no ``bn3``).

Every BatchNorm is :class:`BatchNorm`: ``BatchNorm2d``'s buffers and names,
flax's train-mode update of the running variance.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

from ocflow_torch.ops.resize import resize_bilinear

# flax's lecun_normal is a truncated normal cut at +-2 std; dividing by the
# std of the standard normal cut there gives the samples a std of
# 1/sqrt(fan_in) (jax.nn.initializers.variance_scaling)
TRUNC_STD = 0.87962566103423978


class BatchNorm(nn.BatchNorm2d):
    """``BatchNorm2d`` (its buffers and ``state_dict`` names) with flax's
    train-mode semantics (``flax.linen.BatchNorm``, ``momentum=0.9``): the
    batch is normalized by its biased variance, and the running variance is
    updated with that same biased variance, ``ra = 0.9 ra + 0.1 batch``.
    ``F.batch_norm`` takes the statistics in its one pass over the batch and
    updates the running variance with the unbiased variance, n / (n - 1)
    times the biased one over n values a channel; the update's batch term is
    scaled back by (n - 1) / n. Eval mode is ``BatchNorm2d``'s. With
    ``update_stats`` false (:func:`frozen_stats`) a train-mode forward
    normalizes by the batch and leaves the running statistics as they are,
    as a flax apply in train mode whose ``batch_stats`` are not kept.

    With ``sync_mesh`` set (``parallel.synced_stats``: data parallelism, each
    rank holding a block of the global batch) a train-mode forward takes
    the global batch's statistics, as flax's BatchNorm computes them under
    ``jit`` on global arrays: the global mean and biased variance (see
    :meth:`_global_moments`), the normalization, and the running update
    ``ra = 0.9 ra + 0.1 batch`` from those global values. Eval mode takes
    no collective."""

    def __init__(self, num_features: int, eps: float = 1e-5, device=None, dtype=None):
        super().__init__(num_features, eps=eps, momentum=0.1, device=device, dtype=dtype)
        self.update_stats = True
        self.policy_dtype = None
        self.sync_mesh = None

    def forward(self, x):
        if self.policy_dtype is not None:
            return self._mixed(x)
        if not self.training:
            return super().forward(x)
        if self.sync_mesh is not None:
            return self._synced(x)
        n = x.numel() // x.shape[1]
        # copies, updated by the op: autograd keeps the running statistics
        # the op was given
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, self.momentum, self.eps)
        if self.update_stats:
            with torch.no_grad():
                kept = (1.0 - self.momentum) * self.running_var
                self.running_mean.copy_(mean)
                self.running_var.copy_((var - kept) * ((n - 1) / n) + kept)
                self.num_batches_tracked.add_(1)
        return y

    def _global_moments(self, x: torch.Tensor):
        """The global batch's per-channel mean and biased variance of ``x``
        over ``sync_mesh``, in ``x``'s dtype, in one collective: each rank
        puts its count ``n_r``, its sums ``s_r`` and its centred sums of
        squares ``M2_r`` in its row of an ``[N, 2C + 1]`` matrix, zeros
        elsewhere, and ``Mesh.psum`` (differentiable: the backward's terms
        reach every rank) gathers the rows; then, in rank order on every
        rank, ``mean = sum(s_r) / n`` and ``var = sum(M2_r + n_r (s_r / n_r
        - mean)^2) / n`` (Chan's combination). That is flax's variance
        ``E[x^2] - E[x]^2`` without its cancellation in fp32, which at a few
        values a channel (InpaintingNet's deepest BatchNorms at 64x64) put
        the joint step's gradient over the ranks ten times further from the
        fp64 step than this combination does."""
        c, mesh = x.shape[1], self.sync_mesh
        n = x.numel() // c
        mean = x.mean((0, 2, 3))
        m2 = (x - mean.reshape(1, -1, 1, 1)).square().sum((0, 2, 3))
        rows = x.new_zeros((mesh.size, 2 * c + 1))
        rows[mesh.rank] = torch.cat([x.new_full((1,), n), mean * n, m2])
        rows = mesh.psum(rows)
        counts, sums, m2s = rows[:, :1], rows[:, 1:c + 1], rows[:, c + 1:]
        total = counts.sum()
        mean = sums.sum(0) / total
        var = (m2s + counts * (sums / counts - mean).square()).sum(0) / total
        return mean, var

    def _synced(self, x):
        """The train-mode forward over ``sync_mesh`` (the class docstring),
        in ``x``'s dtype, fp32 at least."""
        acc = torch.promote_types(x.dtype, torch.float32)
        xa = x.to(acc)
        mean, var = self._global_moments(xa)
        if self.update_stats:
            with torch.no_grad():
                for stat, batch in ((self.running_mean, mean), (self.running_var, var)):
                    stat.copy_((1.0 - self.momentum) * stat + self.momentum * batch)
                self.num_batches_tracked.add_(1)
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(acc)
        y = (xa - mean.reshape(shape)) * mul.reshape(shape) + self.bias.to(acc).reshape(shape)
        return y.to(x.dtype)

    def _mixed(self, x):
        """flax's BatchNorm on the variables cast to ``policy_dtype``
        (``models.precision.apply_mixed``; ``weight`` and ``bias`` arrive
        cast, the running statistics are the fp32 buffers), as XLA compiles
        it under ``jax.jit``: the chain in fp32 from the cast values, one
        rounding of the output (XLA keeps the excess precision of fused
        intermediates), the weak-typed constants cast (``bf16(0.9)`` =
        0.8984375, ``bf16(eps)``). Train mode: the batch's mean and biased
        variance in fp32 (``E[x^2] - E[x]^2``, clipped at 0); the update
        ``bf16(0.9) * bf16(ra) + 0.1 * batch`` in fp32 into the buffers.
        Eval mode: the cast running statistics. Over ``sync_mesh`` the
        train-mode moments are the global batch's, from the ranks' fp32
        moments (:meth:`_global_moments`)."""
        half = self.policy_dtype
        shape = (1, -1, 1, 1)

        def cast(v):
            return v.to(half).float()

        eps = float(torch.tensor(self.eps, dtype=half))
        x32 = x.float()
        if self.training:
            if self.sync_mesh is not None:
                mean, var = self._global_moments(x32)
            else:
                mean = x32.mean((0, 2, 3))
                var = ((x32 * x32).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
            if self.update_stats:
                keep = float(torch.tensor(1.0 - self.momentum, dtype=half))
                with torch.no_grad():
                    for stat, batch in ((self.running_mean, mean), (self.running_var, var)):
                        stat.copy_(cast(stat) * keep + self.momentum * batch)
                    self.num_batches_tracked.add_(1)
        else:
            mean, var = cast(self.running_mean), cast(self.running_var)
        mul = torch.rsqrt(var + eps) * self.weight.float()
        y = (x32 - mean.reshape(shape)) * mul.reshape(shape) + self.bias.float().reshape(shape)
        return y.to(half)


@contextlib.contextmanager
def _norms_set(module: nn.Module, name: str, value):
    """Inside, every :class:`BatchNorm` of ``module`` has its attribute
    ``name`` set to ``value``; each one is given back on exit."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    saved = [getattr(m, name) for m in norms]
    for m in norms:
        setattr(m, name, value)
    try:
        yield
    finally:
        for m, v in zip(norms, saved):
            setattr(m, name, v)


def policy_stats(module: nn.Module, dtype):
    """Inside, every :class:`BatchNorm` of ``module`` runs flax's
    BatchNorm under the mixed-precision policy of ``dtype``
    (:meth:`BatchNorm._mixed`)."""
    return _norms_set(module, "policy_dtype", dtype)


def frozen_stats(module: nn.Module):
    """Inside, every :class:`BatchNorm` of ``module`` leaves its running
    statistics alone in train mode (``update_stats`` false)."""
    return _norms_set(module, "update_stats", False)


class ConvBlock(nn.Sequential):
    """Conv, optional BatchNorm, LeakyReLU(0.1); torch padding
    ``(k - 1) // 2 * dilation`` unless given. With ``use_bn`` the conv has
    no bias and :class:`BatchNorm` follows (eps 1e-5, torch momentum 0.1 =
    flax momentum 0.9)."""

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
            layers.append(BatchNorm(cout, **kw))
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


class PredictFlowStack(nn.Sequential):
    """conv(32) -> conv(16) -> conv(2) flow head of SimpleFlowNet, each 3x3,
    the first two with LeakyReLU(0.1)."""

    def __init__(self, cin: int, cout: int = 2):
        super().__init__(ConvBlock(cin, 32), ConvBlock(32, 16),
                         nn.Sequential(nn.Conv2d(16, cout, 3, padding=1)))


class PredictOccStack(nn.Sequential):
    """conv(32) -> conv(16) -> conv(1) occlusion head of SimpleOcclusionNet
    and SimpleFlowOccNet (``ocflow_tpu/models/occlusion_nets.py:
    PredictOccStack``), each 3x3, the first two with LeakyReLU(0.1), then a
    sigmoid unless ``sigmoid`` is false (the logit). Keys as
    :class:`PredictFlowStack`'s."""

    def __init__(self, cin: int, sigmoid: bool = True):
        last = [nn.Conv2d(16, 1, 3, padding=1)] + ([nn.Sigmoid()] if sigmoid else [])
        super().__init__(ConvBlock(cin, 32), ConvBlock(32, 16), nn.Sequential(*last))


class _ProjBlock(nn.Module):
    """Three conv (no bias) + :class:`BatchNorm` + LeakyReLU(0.1) stages,
    ``conv1..3`` / ``bn1..3``: the first of kernel ``k1``, stride ``s1``,
    no padding (1x1 or 2x2), the second ``k2`` x ``k2`` (padding ``(k2 -
    1) // 2``), the third 1x1. With ``last_act`` false the third stage is
    the bare conv (no ``bn3``, no LeakyReLU)."""

    def __init__(self, cin: int, inter: int, cout: int, k1: int, s1: int, k2: int = 3,
                 last_act: bool = True):
        super().__init__()
        specs = ((cin, inter, k1, s1, 0), (inter, inter, k2, 1, (k2 - 1) // 2),
                 (inter, cout, 1, 1, 0))
        for j, (ci, co, k, st, p) in enumerate(specs, 1):
            self.add_module(f"conv{j}", nn.Conv2d(ci, co, k, stride=st, padding=p,
                                                  bias=False))
            if j < 3 or last_act:
                self.add_module(f"bn{j}", BatchNorm(co))
        self.last_act = last_act

    def forward(self, x):
        for j in (1, 2, 3):
            x = getattr(self, f"conv{j}")(x)
            if j < 3 or self.last_act:
                x = F.leaky_relu(getattr(self, f"bn{j}")(x), 0.1)
        return x


class ProjDown(_ProjBlock):
    """Projection-bottleneck 2x downsample: 2x2/s2 conv to ``cin //
    proj_ratio`` channels (at least 1), ``kernel_size`` conv (3x3 unless
    given), 1x1 conv to ``cout``."""

    def __init__(self, cin: int, cout: int, proj_ratio: int = 4, kernel_size: int = 3):
        super().__init__(cin, max(cin // proj_ratio, 1), cout, 2, 2, kernel_size)


class ProjUp(_ProjBlock):
    """Projection-bottleneck 2x upsample with a skip: ``x`` resized 2x
    (bilinear, ``align_corners=False``), zero-padded to the skip's size
    with the odd pixel after, ``cat([skip, x])`` (``cin`` channels in all),
    then 1x1 conv to ``cin // proj_ratio``, 3x3 conv, 1x1 conv to
    ``cout`` (bare with ``activation`` false)."""

    def __init__(self, cin: int, cout: int, proj_ratio: int = 4, activation: bool = True):
        super().__init__(cin, max(cin // proj_ratio, 1), cout, 1, 1, last_act=activation)

    def forward(self, x, skip):
        h, w = x.shape[2] * 2, x.shape[3] * 2
        x = resize_bilinear(x, h, w, align_corners=False)
        dy, dx = skip.shape[2] - h, skip.shape[3] - w
        if dy or dx:
            x = F.pad(x, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
        return super().forward(torch.cat([skip, x], 1))


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded init drawing from flax's default initializers, as the JAX
    package's ``init`` does: every conv and transposed conv, in the order
    of ``module.modules()``, draws its weight from LeCun-normal truncated at
    +-2 std (``trunc_normal_`` with std ``1/sqrt(fan_in)/0.8796``, one draw
    of ``generator`` per weight, so the samples' std is 1/sqrt(fan_in));
    biases are zero; every BatchNorm starts at the identity (scale 1, bias
    0, running mean 0, running variance 1). The fan-in is ``cin * kh * kw``
    for both: flax reads a ``ConvTranspose`` kernel ``(kh, kw, cin, cout)``
    as it reads a conv's."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
                continue
            if isinstance(m, nn.ConvTranspose2d):
                cin, _, kh, kw = m.weight.shape
                fan_in = cin * kh * kw
            elif isinstance(m, nn.Conv2d):
                fan_in = math.prod(m.weight.shape[1:])
            else:
                continue
            std = 1.0 / math.sqrt(fan_in) / TRUNC_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
