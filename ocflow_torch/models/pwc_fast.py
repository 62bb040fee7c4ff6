"""Fused serving forward of FlowNetCV (port of ``ocflow_tpu/models/pwc_fast.py``
``fast_apply``, bf16 and fp32; the W8A8 variant is not ported yet).

The same function as ``FlowNetCV.forward`` on the same weights, with the hot
blocks on the hand-written Hopper kernels:

- the encoder: one conv group per level (stride-2 conv + pair) over
  ``cat(im1, im2)`` on the batch axis;
- per decoder level 6..3: the cost-volume kernel, then one conv group with
  the five DenseNet growth convs, the flow head and the up-flow / up-feat
  transposed convs folded in as 3x3 PHASE convs (8 outputs = 2x2 sub-pixel
  phases x 2 channels), so the flow and the block activations feed the next
  level only through the two phase-packed tensors;
- level 2: one group with the dense block, the flow head and context conv
  1; the dilated context convs (d = 2, 4, 8, 16) as plain ``F.conv2d``
  (the JAX path leaves them to XLA too); then the context tail 64 -> 32 -> 2
  as one more group, whose output is added to the flow.

Warps, feature normalization, the decoder-input assembly and the final
resize are plain PyTorch. Weights are packed once per (model, dtype,
device) by :func:`prepare` and cached on the model until they change.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from ocflow_torch import resolve_device
from ocflow_torch.kernels.conv_chain import ConvGroup, ConvSpec, conv_group, prepare_group
from ocflow_torch.kernels.cost_volume import cost_volume
from ocflow_torch.models.pwc_net import CONTEXT, DECODER_LEVELS, GROWTH, FlowNetCV
from ocflow_torch.ops.cost_volume import normalize_features
from ocflow_torch.ops.resize import resize_bilinear
from ocflow_torch.ops.warp import warp

# (phase, 3x3 tap index, transposed-conv kernel index) of a stride-2 4x4
# ConvTranspose2d(padding=1): output row 2h+a sums input rows h-1, h (a=0,
# kernel rows 3, 1) or h, h+1 (a=1, kernel rows 2, 0)
_PHASE_TAPS = ((0, 0, 3), (0, 1, 1), (1, 1, 2), (1, 2, 0))


def _split_newest_first(w: torch.Tensor, block_ch) -> torch.Tensor:
    """Reorder the input channels of an OIHW weight over a decoder concat
    (NEWEST first: ``[c_j, ..., c_1, x]``) to block order ``[x, c_1, ...,
    c_j]``, the order of the conv group's reads."""
    parts, off = {}, 0
    for i in range(len(block_ch) - 1, 0, -1):
        parts[i] = w[:, off:off + block_ch[i]]
        off += block_ch[i]
    parts[0] = w[:, off:off + block_ch[0]]
    if off + block_ch[0] != w.shape[1]:
        raise ValueError(f"blocks {block_ch} do not cover {w.shape[1]} channels")
    return torch.cat([parts[i] for i in range(len(block_ch))], 1)


def _phase_conv_weights(deconv: nn.ConvTranspose2d):
    """A ConvTranspose2d(k=4, s=2, p=1) as one 3x3 conv (padding 1) with
    ``4 * cout`` outputs, channel ``(a * 2 + b) * cout + o`` holding output
    phase (row a, column b) of channel o. Returns ``(weight, bias)``."""
    wt, bias = deconv.weight.detach(), deconv.bias.detach()
    cin, cout = wt.shape[:2]
    w3 = wt.new_zeros(2, 2, cout, cin, 3, 3)
    for a, di, kh in _PHASE_TAPS:
        for b, dj, kw in _PHASE_TAPS:
            w3[a, b, :, :, di, dj] = wt[:, :, kh, kw].t()
    return w3.reshape(4 * cout, cin, 3, 3), bias.repeat(4)


def _unpack_phases(y8: torch.Tensor) -> torch.Tensor:
    """``[B, 4c, H, W]`` phase-packed -> ``[B, c, 2H, 2W]``."""
    b, c4, h, w = y8.shape
    c = c4 // 4
    y = y8.reshape(b, 2, 2, c, h, w).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(b, c, 2 * h, 2 * w)


@dataclass
class FastWeights:
    """The model's weights packed for the kernels (see :func:`prepare`)."""

    encoder: list[ConvGroup]
    decoders: list[ConvGroup]   # levels 6..3
    level2: ConvGroup
    ctx_dilated: list[tuple[torch.Tensor, torch.Tensor, int]]
    ctx_tail: ConvGroup

    def groups(self) -> list[ConvGroup]:
        """Every conv group, in the order one forward runs them."""
        return [*self.encoder, *self.decoders, self.level2, self.ctx_tail]


def _decoder_specs(n_in: int, head_emit: bool) -> list[ConvSpec]:
    specs = [ConvSpec(tuple(range(n_in + j)), g) for j, g in enumerate(GROWTH)]
    specs.append(ConvSpec(tuple(range(n_in + len(GROWTH))), 2, act=False,
                          emit=head_emit))
    return specs


def _decoder_weights(dec, c0: int):
    block_ch = [c0, *GROWTH]
    ws = [_split_newest_first(c.weight.detach(), block_ch[:j + 1])
          for j, c in enumerate(dec.convs())]
    return ws, [c.bias.detach() for c in dec.convs()]


def _build(model: FlowNetCV, dtype: torch.dtype, device) -> FastWeights:
    kw = dict(dtype=dtype, device=device)
    encoder = []
    for convs in model.encoder.levels():
        c = convs[0].out_channels
        specs = [ConvSpec((0,), c, stride=2), ConvSpec((1,), c),
                 ConvSpec((2,), c, emit=True)]
        encoder.append(prepare_group(
            [m.weight for m in convs], [m.bias for m in convs], specs, 1, **kw))

    decoders = []
    for dec, lvl in zip(model.decoders[:-1], DECODER_LEVELS[:-1]):
        n_in = 1 if lvl == DECODER_LEVELS[0] else 4
        c0 = dec.convs()[0].in_channels
        ws, bs = _decoder_weights(dec, c0)
        specs = _decoder_specs(n_in, head_emit=False)
        deconv, upfeat = model.upsamplers(lvl)
        fw, fb = _phase_conv_weights(deconv)
        uw, ub = _phase_conv_weights(upfeat)
        ws += [fw, _split_newest_first(uw, [c0, *GROWTH])]
        bs += [fb, ub]
        specs += [ConvSpec((n_in + len(GROWTH),), 8, act=False, emit=True),
                  ConvSpec(tuple(range(n_in + len(GROWTH))), 8, act=False,
                           emit=True)]
        decoders.append(prepare_group(ws, bs, specs, n_in, **kw))

    dec2 = model.decoders[-1]
    c0 = dec2.convs()[0].in_channels
    ws, bs = _decoder_weights(dec2, c0)
    specs = _decoder_specs(4, head_emit=True)
    ctx = model.context.convs()
    ws.append(_split_newest_first(ctx[0].weight.detach(), [c0, *GROWTH]))
    bs.append(ctx[0].bias.detach())
    specs.append(ConvSpec(tuple(range(4 + len(GROWTH))), CONTEXT[0][0],
                          emit=True))
    level2 = prepare_group(ws, bs, specs, 4, **kw)

    dilated = [(m.weight.detach().to(**kw), m.bias.detach().to(**kw), d)
               for m, (_, d) in zip(ctx[1:-2], CONTEXT[1:-1])]
    tail = prepare_group(
        [ctx[-2].weight, ctx[-1].weight], [ctx[-2].bias, ctx[-1].bias],
        [ConvSpec((0,), CONTEXT[-1][0]), ConvSpec((1,), 2, act=False, emit=True)],
        1, **kw)
    return FastWeights(encoder, decoders, level2, dilated, tail)


def _weights_version(model: nn.Module) -> tuple:
    """Changes whenever a parameter is replaced (``.to``, ``.bfloat16``) or
    written in place (``load_state_dict``, an optimizer step)."""
    return tuple((p.data_ptr(), p._version) for p in model.parameters())


def prepare(model: FlowNetCV, dtype: torch.dtype, device) -> FastWeights:
    """Pack ``model``'s weights for the kernels in ``dtype`` on ``device``.

    The packed copy is cached on the model and reused until a parameter
    changes; then every cached packing is dropped and this one rebuilt."""
    version = _weights_version(model)
    cached = model.__dict__.get("_fast_weights")
    if cached is None or cached[0] != version:
        cached = model.__dict__["_fast_weights"] = (version, {})
    cache = cached[1]
    key = (dtype, torch.device(device))
    if key not in cache:
        with torch.no_grad():
            cache[key] = _build(model, dtype, device)
    return cache[key]


def _leaky(x):
    return F.leaky_relu(x, 0.1)


def _decoder(group: ConvGroup, inputs):
    up_flow8, up_feat8 = conv_group(inputs, group)
    return _unpack_phases(up_flow8), _unpack_phases(up_feat8)


def _level2(fw: FastWeights, inputs):
    flow, y = conv_group(inputs, fw.level2)
    for w, b, d in fw.ctx_dilated:
        y = _leaky(F.conv2d(y, w, b, padding=d, dilation=d))
    (res,) = conv_group([y], fw.ctx_tail)
    return flow + res


def _decode(model: FlowNetCV, fw: FastWeights, f1, f2):
    d = model.displacement
    c16, c26 = f1[5], f2[5]
    if model.normalize:
        c16, c26 = normalize_features([c16, c26])
    corr = _leaky(cost_volume(c16.contiguous(), c26.contiguous(), d))
    up_flow, up_feat = _decoder(fw.decoders[0], [corr])
    flow2 = None
    for i, (lvl, scale) in enumerate(zip((4, 3, 2, 1), model.warp_scales)):
        warped = warp(f2[lvl], up_flow * scale,
                      align_corners=model.warp_align_corners)
        c1n, wn = f1[lvl], warped
        if model.normalize:
            c1n, wn = normalize_features([c1n, wn])
        c1n = c1n.contiguous()
        corr = _leaky(cost_volume(c1n, wn.contiguous(), d))
        inputs = [corr, c1n, up_flow, up_feat]
        if lvl > 1:
            up_flow, up_feat = _decoder(fw.decoders[i + 1], inputs)
        else:
            flow2 = _level2(fw, inputs)
    return flow2.float()


def fast_apply(model_or_state, x: torch.Tensor, device=None):
    """Fused replacement for ``FlowNetCV.forward``.

    ``model_or_state``: a ``FlowNetCV`` / ``PWCNet``, or a FlowNetCV
    ``state_dict`` (then packed on every call). ``x``: ``[B, H, W, 6]``
    (H, W divisible by 64); its dtype (fp32 or bf16) is the compute dtype.
    Runs on ``device`` (default ``cuda``; pass ``"cpu"`` for the plain
    versions of the kernels). Returns ``(flow_full [B, H, W, 2],
    flow_quarter [B, H/4, W/4, 2])`` in fp32.
    """
    dev = resolve_device(device)
    if isinstance(model_or_state, Mapping):
        model = FlowNetCV(device=dev)
        model.load_state_dict(model_or_state)
    else:
        model = model_or_state
    x = x.to(dev)
    with torch.no_grad():
        fw = prepare(model, x.dtype, dev)
        b = x.shape[0]
        img = torch.cat([x[..., :3], x[..., 3:]], 0).permute(0, 3, 1, 2)
        feats, h = [], img.contiguous()
        for group in fw.encoder:
            (h,) = conv_group([h], group)
            feats.append(h)
        flow2 = _decode(model, fw, [f[:b] for f in feats],
                        [f[b:] for f in feats])
        hh, ww = flow2.shape[2] * 4, flow2.shape[3] * 4
        flow1 = resize_bilinear(flow2, hh, ww, align_corners=True) * 20.0
    return (flow1.permute(0, 2, 3, 1).contiguous(),
            (flow2 * 5.0).permute(0, 2, 3, 1).contiguous())
