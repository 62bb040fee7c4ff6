"""Fused forward of FlowNetCV (port of ``ocflow_tpu/models/pwc_fast.py``:
``fast_apply`` in bf16, fp32 and W8A8, ``calibrate_q8``, and the training
forms ``fast_apply(..., diff=True)`` and ``fast_apply_pair``).

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
device, W8A8 scales) by :func:`prepare` and cached on the model until they
change.

Training (``diff=True``, and the forward half of :func:`fast_apply_pair`):
the eager encoder under autograd; per decoder level one ``conv_group_diff``
(the conv-group kernel forward with every block kept, cuDNN conv VJPs
backward) with the five growth convs and the flow head, the up-flow and
up-feat as ``F.conv_transpose2d`` (no phase-conv fusion, as in the JAX
diff path); at level 2 one group with context conv 1, the rest of the
context network eager; the differentiable cost volume (its backward a
kernel too). Weights are reordered and cast to the compute dtype inside
the graph, so gradients reach the fp32 master parameters.

Several ranks (``parallel.mesh``): :func:`fast_apply_sharded` and
:func:`fast_apply_pair_sharded` run the same forwards on each rank's
contiguous block of the global batch (``gather=True``: the whole batch's
flows on every rank).

W8A8 (``fast_apply(..., q8=scales)``, scales from :func:`calibrate_q8`):
every decoder group L6..L2 runs on the int8 conv-group kernel
(``kernels/conv_chain_q8.py``): the five growth convs store int8 codes; the
flow head, context conv 1 and the up-feat phase conv read the int8 blocks
and emit bf16; the up-flow phase conv reads the flow head from the bf16
side stripe on the bf16 kernel. With ``'enc'`` in the scales each encoder
level is one int8 group (stride-2 conv + pair, codes chained level to
level, features dequantized once for the warps and cost volumes); with
``'ctx'`` the dilated context chain, 64 -> 32 and the flow head are one
int8 group in place of the dilated convs and the tail.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from ocflow_torch import full_fp32_convs, resolve_device
from ocflow_torch.kernels.conv_chain import (ConvGroup, ConvSpec, conv_group,
                                              conv_group_diff, is_staged, is_tma,
                                              prepare_group)
from ocflow_torch.kernels.conv_chain_q8 import (ConvGroupQ8, amax_scale, conv_group_q8,
                                                dequantize_q8, is_staged_q8,
                                                prepare_group_q8, quantize_q8)
from ocflow_torch.kernels.cost_volume import cost_volume
from ocflow_torch.models.pwc_net import (CONTEXT, DECODER_LEVELS, GROWTH, LEVEL_FEATURES,
                                         FlowNetCV)
from ocflow_torch.ops.cost_volume import normalize_features
from ocflow_torch.ops.resize import resize_bilinear
from ocflow_torch.ops.warp import warp
from ocflow_torch.parallel.mesh import shard_batch

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
    """``[B, 4c, H, W]`` phase-packed -> ``[B, c, 2H, 2W]``, contiguous
    (the reshape copies, except at H = W = 1, where it would return a view
    whose strides the conv kernels do not read)."""
    b, c4, h, w = y8.shape
    c = c4 // 4
    y = y8.reshape(b, 2, 2, c, h, w).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(b, c, 2 * h, 2 * w).contiguous()


@dataclass
class FastWeights:
    """The model's weights packed for the kernels (see :func:`prepare`).
    A group is a ``ConvGroup`` (bf16/fp32) or, under W8A8, a
    ``ConvGroupQ8``."""

    encoder: list
    decoders: list              # levels 6..3
    level2: ConvGroup | ConvGroupQ8
    ctx_dilated: list[tuple[torch.Tensor, torch.Tensor, int]]  # empty under 'ctx'
    ctx_tail: ConvGroup | ConvGroupQ8  # 64 -> 32 -> 2, or the whole W8A8 chain

    def groups(self) -> list:
        """Every conv group, in the order one forward runs them."""
        return [*self.encoder, *self.decoders, self.level2, self.ctx_tail]

    def launch_counts(self, size: tuple[int, int, int] | None = None) -> dict[str, int]:
        """Conv-kernel launches of one forward: ``conv_group`` (bf16/fp32
        kernels), ``conv_group_staged`` (those of them of stride 1 and
        dilation 1 in bf16: the staged or the TMA kernel),
        ``conv_group_q8`` (int8 kernel) and ``conv_group_q8_staged`` (those
        of them on its staged kernel); with ``size``, the input's ``(B, H,
        W)``, also ``conv_group_tma`` (those on the TMA kernel, by
        ``is_tma`` at each group's shape)."""
        shapes = [None] * len(self.groups()) if size is None else self.group_shapes(size)
        convs = [(torch.bfloat16 if isinstance(g, ConvGroupQ8) else g.dtype, s,
                  None if shape is None else shape[1:])
                 for g, shape in zip(self.groups(), shapes) for j, s in enumerate(g.specs)
                 if not (isinstance(g, ConvGroupQ8) and g.int8_read[j])]
        convs8 = [s for g in self.groups() if isinstance(g, ConvGroupQ8)
                  for j, s in enumerate(g.specs) if g.int8_read[j]]
        out = {"conv_group": len(convs),
               "conv_group_staged": sum(is_staged(d, s) for d, s, _ in convs),
               "conv_group_q8": len(convs8),
               "conv_group_q8_staged": sum(map(is_staged_q8, convs8))}
        if size is not None:
            out["conv_group_tma"] = sum(is_tma(*c) for c in convs)
        return out

    def group_shapes(self, size: tuple[int, int, int]) -> list[tuple[int, int, int]]:
        """Each group's output ``(B, H, W)``, in :meth:`groups`' order, for
        an input of ``size = (B, H, W)``: the encoder's levels over the two
        frames (2B), the decoders at levels 6..3, level 2 and the context
        tail at a quarter of the input."""
        b, h, w = size
        enc = [(2 * b, h >> lvl, w >> lvl) for lvl in range(1, len(self.encoder) + 1)]
        dec = [(b, h >> lvl, w >> lvl) for lvl in DECODER_LEVELS[:len(self.decoders)]]
        return [*enc, *dec, (b, h >> 2, w >> 2), (b, h >> 2, w >> 2)]


def _decoder_specs(n_in: int, head_emit: bool, q8: bool = False) -> list[ConvSpec]:
    specs = [ConvSpec(tuple(range(n_in + j)), g, q8=q8)
             for j, g in enumerate(GROWTH)]
    specs.append(ConvSpec(tuple(range(n_in + len(GROWTH))), 2, act=False,
                          emit=head_emit))
    return specs


def _decoder_weights(dec, c0: int):
    block_ch = [c0, *GROWTH]
    ws = [_split_newest_first(c.weight.detach(), block_ch[:j + 1])
          for j, c in enumerate(dec.convs())]
    return ws, [c.bias.detach() for c in dec.convs()]


def _decoder_inputs(model: FlowNetCV, lvl: int) -> tuple[int, ...]:
    """Channels of a decoder's inputs: the cost volume, then (below level
    6) the level's features, the up-sampled flow and features."""
    nk = (2 * model.displacement + 1) ** 2
    return (nk,) if lvl == DECODER_LEVELS[0] else (nk, LEVEL_FEATURES[lvl - 1], 2, 2)


def _group(ws, bs, specs, in_ch, dtype, device, q8=None, scales=None):
    """A bf16/fp32 group, or with ``q8`` (``{'in': s, ...}``) a W8A8 group
    whose spec scales are ``scales``."""
    if q8 is None:
        return prepare_group(ws, bs, specs, len(in_ch), dtype, device, in_ch)
    return prepare_group_q8(ws, bs, specs, in_ch, q8["in"], scales, device)


def _build(model: FlowNetCV, dtype: torch.dtype, device, q8=None) -> FastWeights:
    kw = dict(dtype=dtype, device=device)
    enc = q8.get("enc") if q8 else None
    encoder, cin = [], 3
    for lvl, convs in enumerate(model.encoder.levels()):
        c = convs[0].out_channels
        qs = None if enc is None else {
            "in": enc["in"] if lvl == 0 else enc["levels"][lvl - 1][2]}
        specs = [ConvSpec((0,), c, stride=2, q8=qs is not None),
                 ConvSpec((1,), c, q8=qs is not None),
                 ConvSpec((2,), c, emit=True, q8=qs is not None)]
        encoder.append(_group(
            [m.weight for m in convs], [m.bias for m in convs], specs, (cin,),
            **kw, q8=qs, scales=None if enc is None else enc["levels"][lvl]))
        cin = c

    decoders = []
    for i, (dec, lvl) in enumerate(zip(model.decoders[:-1], DECODER_LEVELS[:-1])):
        in_ch = _decoder_inputs(model, lvl)
        n_in = len(in_ch)
        c0 = dec.convs()[0].in_channels
        ws, bs = _decoder_weights(dec, c0)
        specs = _decoder_specs(n_in, head_emit=False, q8=q8 is not None)
        deconv, upfeat = model.upsamplers(lvl)
        fw, fb = _phase_conv_weights(deconv)
        uw, ub = _phase_conv_weights(upfeat)
        ws += [fw, _split_newest_first(uw, [c0, *GROWTH])]
        bs += [fb, ub]
        specs += [ConvSpec((n_in + len(GROWTH),), 8, act=False, emit=True),
                  ConvSpec(tuple(range(n_in + len(GROWTH))), 8, act=False,
                           emit=True)]
        qs = q8[f"dec{i}"] if q8 else None
        decoders.append(_group(ws, bs, specs, in_ch, **kw, q8=qs,
                               scales=qs and [*qs["growth"], None, None, None]))

    dec2 = model.decoders[-1]
    c0 = dec2.convs()[0].in_channels
    ws, bs = _decoder_weights(dec2, c0)
    specs = _decoder_specs(4, head_emit=True, q8=q8 is not None)
    ctx = model.context.convs()
    ws.append(_split_newest_first(ctx[0].weight.detach(), [c0, *GROWTH]))
    bs.append(ctx[0].bias.detach())
    specs.append(ConvSpec(tuple(range(4 + len(GROWTH))), CONTEXT[0][0],
                          emit=True))
    qs = q8[f"dec{len(DECODER_LEVELS) - 1}"] if q8 else None
    level2 = _group(ws, bs, specs, _decoder_inputs(model, DECODER_LEVELS[-1]),
                    **kw, q8=qs, scales=qs and [*qs["growth"], None, None])

    if q8 and "ctx" in q8:
        # dilated chain d=2..16, 64 -> 32 and the flow head as one group
        specs = [ConvSpec((j,), g, dilation=d, q8=True)
                 for j, (g, d) in enumerate(CONTEXT[1:])]
        specs.append(ConvSpec((len(CONTEXT) - 1,), 2, act=False, emit=True))
        tail = prepare_group_q8(
            [m.weight for m in ctx[1:]], [m.bias for m in ctx[1:]], specs,
            (CONTEXT[0][0],), q8["ctx"]["in"], [*q8["ctx"]["chain"], None],
            device)
        return FastWeights(encoder, decoders, level2, [], tail)
    dilated = [(m.weight.detach().to(**kw), m.bias.detach().to(**kw), d)
               for m, (_, d) in zip(ctx[1:-2], CONTEXT[1:-1])]
    tail = prepare_group(
        [ctx[-2].weight, ctx[-1].weight], [ctx[-2].bias, ctx[-1].bias],
        [ConvSpec((0,), CONTEXT[-1][0]), ConvSpec((1,), 2, act=False, emit=True)],
        1, **kw, in_channels=(CONTEXT[-2][0],))
    return FastWeights(encoder, decoders, level2, dilated, tail)


def _weights_version(model: nn.Module) -> tuple:
    """Changes whenever a parameter is replaced (``.to``, ``.bfloat16``) or
    written in place (``load_state_dict``, an optimizer step)."""
    return tuple((p.data_ptr(), p._version) for p in model.parameters())


def _scales_key(q8):
    """The W8A8 scales as a hashable value (every scale as a float)."""
    if isinstance(q8, Mapping):
        return tuple((k, _scales_key(q8[k])) for k in sorted(q8))
    if isinstance(q8, (list, tuple)):
        return tuple(_scales_key(v) for v in q8)
    return float(q8)


def prepare(model: FlowNetCV, dtype: torch.dtype, device, q8=None) -> FastWeights:
    """Pack ``model``'s weights for the kernels in ``dtype`` on ``device``;
    with ``q8`` (scales from :func:`calibrate_q8`) fold and quantize the
    W8A8 groups with those scales.

    The packed copy is cached on the model, keyed by dtype, device and the
    scale values, and reused until a parameter changes; then every cached
    packing is dropped and this one rebuilt."""
    version = _weights_version(model)
    cached = model.__dict__.get("_fast_weights")
    if cached is None or cached[0] != version:
        cached = model.__dict__["_fast_weights"] = (version, {})
    cache = cached[1]
    key = (dtype, torch.device(device))
    if q8 is not None:
        key += (_scales_key(q8),)
    if key not in cache:
        with torch.no_grad():
            cache[key] = _build(model, dtype, device, q8)
    return cache[key]


def _leaky(x):
    return F.leaky_relu(x, 0.1)


def _run(group, inputs) -> list[torch.Tensor]:
    """``conv_group``, or for a W8A8 group ``conv_group_q8`` on the inputs'
    codes (each quantized with the group's input scale)."""
    if isinstance(group, ConvGroupQ8):
        return conv_group_q8(
            [quantize_q8(t.contiguous(), group.in_scale) for t in inputs], group)
    return conv_group(inputs, group)


def _decoder(group, inputs):
    up_flow8, up_feat8 = _run(group, inputs)
    dt = inputs[0].dtype
    return _unpack_phases(up_flow8).to(dt), _unpack_phases(up_feat8).to(dt)


def _level2(fw: FastWeights, inputs):
    flow, y = _run(fw.level2, inputs)
    if not isinstance(fw.ctx_tail, ConvGroupQ8):
        y = y.to(inputs[0].dtype)
        for w, b, d in fw.ctx_dilated:
            y = _leaky(F.conv2d(y, w, b, padding=d, dilation=d))
    (res,) = _run(fw.ctx_tail, [y])
    return flow + res


def _decode(model: FlowNetCV, f1, f2, decoder, level2):
    """Coarse-to-fine decode of the feature pyramids ``f1``, ``f2``:
    ``decoder(i, inputs) -> (up_flow, up_feat)`` runs decoder ``i`` (0 =
    level 6), ``level2(inputs)`` the level-2 block with the context
    network. Returns the level-2 flow ``[B, 2, H/4, W/4]``."""
    d = model.displacement
    c16, c26 = f1[5], f2[5]
    if model.normalize:
        c16, c26 = normalize_features([c16, c26])
    corr = _leaky(cost_volume(c16.contiguous(), c26.contiguous(), d))
    up_flow, up_feat = decoder(0, [corr])
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
            up_flow, up_feat = decoder(i + 1, inputs)
        else:
            flow2 = level2(inputs)
    return flow2


def _decode_fused(model: FlowNetCV, fw: FastWeights, f1, f2):
    """The serving decode on the packed groups ``fw``."""
    return _decode(model, f1, f2, lambda i, x: _decoder(fw.decoders[i], x),
                   lambda x: _level2(fw, x))


def _decode_diff(model: FlowNetCV, f1, f2):
    """The gradient-carrying decode: ``conv_group_diff`` groups, no
    phase-conv fusion."""
    return _decode(model, f1, f2, lambda i, x: _diff_decoder(model, i, x),
                   lambda x: _diff_level2(model, x))


def _encode(fw: FastWeights, img: torch.Tensor) -> list[torch.Tensor]:
    """The feature pyramid of ``img`` (NCHW). W8A8 groups chain int8 codes
    level to level; each level's features are dequantized once."""
    feats, h = [], img.contiguous()
    q8 = isinstance(fw.encoder[0], ConvGroupQ8)
    if q8:
        h = quantize_q8(h, fw.encoder[0].in_scale)
    for group in fw.encoder:
        (h,) = conv_group_q8([h], group) if q8 else conv_group([h], group)
        feats.append(dequantize_q8(h, group.scales[-1], img.dtype) if q8 else h)
    return feats


def _flows(flow2: torch.Tensor):
    """``(flow_full [B, H, W, 2], flow_quarter [B, H/4, W/4, 2])`` from the
    level-2 flow ``[B, 2, H/4, W/4]``."""
    flow2 = flow2.float()
    hh, ww = flow2.shape[2] * 4, flow2.shape[3] * 4
    flow1 = resize_bilinear(flow2, hh, ww, align_corners=True) * 20.0
    return (flow1.permute(0, 2, 3, 1).contiguous(),
            (flow2 * 5.0).permute(0, 2, 3, 1).contiguous())


def _model(model_or_state, dev) -> FlowNetCV:
    if isinstance(model_or_state, Mapping):
        model = FlowNetCV(device=dev)
        model.load_state_dict(model_or_state)
        return model
    return model_or_state


def _images(x: torch.Tensor) -> torch.Tensor:
    """``[B, H, W, 6]`` -> ``cat(im1, im2)`` on the batch axis, NCHW."""
    return torch.cat([x[..., :3], x[..., 3:]], 0).permute(0, 3, 1, 2).contiguous()


def fast_apply(model_or_state, x: torch.Tensor, q8=None, device=None,
               diff: bool = False):
    """Fused replacement for ``FlowNetCV.forward``.

    ``model_or_state``: a ``FlowNetCV`` / ``PWCNet``, or a FlowNetCV
    ``state_dict`` (then packed on every call). ``x``: ``[B, H, W, 6]``
    (H, W divisible by 64); its dtype (fp32 or bf16) is the compute dtype.
    ``q8``: W8A8 scales from :func:`calibrate_q8` (the decoders run int8;
    ``'enc'`` / ``'ctx'`` in the scales add the encoder / context chain).
    ``diff``: the gradient-carrying form (eager encoder, ``conv_group_diff``
    decoders, the differentiable cost volume; weights cast to ``x``'s dtype
    inside the graph, so gradients reach the model's parameters); serving
    only without it, and not with ``q8``.
    Runs on ``device`` (default ``cuda``; pass ``"cpu"`` for the plain
    versions of the kernels). Returns ``(flow_full [B, H, W, 2],
    flow_quarter [B, H/4, W/4, 2])`` in fp32. In fp32 its cuDNN
    convolutions run without TF32 (``full_fp32_convs``).
    """
    dev = resolve_device(device)
    model = _model(model_or_state, dev)
    x = x.to(dev)
    b = x.shape[0]
    if diff and q8 is not None:
        raise ValueError("fast_apply: W8A8 is a serving mode; diff takes no q8")
    with full_fp32_convs(x.dtype):
        if diff:
            feats = _encode_diff(model, _images(x))
            return _flows(_decode_diff(model, [f[:b] for f in feats],
                                       [f[b:] for f in feats]))
        with torch.no_grad():
            fw = prepare(model, x.dtype, dev, q8)
            feats = _encode(fw, _images(x))
            return _flows(_decode_fused(model, fw, [f[:b] for f in feats],
                                        [f[b:] for f in feats]))


def fast_apply_pair(model: FlowNetCV, x: torch.Tensor, q8=None, device=None,
                    mark=None):
    """Forward AND backward flow from ONE encoder pass (port of
    ``ocflow_tpu`` ``fast_apply_pair``), for the occlusion-aware step.

    The encoder runs once over ``cat(im1, im2)``; the forward flow is the
    gradient-carrying decode of :func:`fast_apply` with ``diff=True``; the
    backward flow (frame 2 -> 1) is the serving decode, under ``no_grad``,
    of the detached features with ``f1`` / ``f2`` swapped (``q8``: W8A8
    scales for that decode only). Equal to a second forward on the swapped
    input: the features are the same values and the top-level feature
    normalization is symmetric in its two arguments. ``x``'s dtype is the
    compute dtype. Returns ``((flow_full, flow_quarter), (back_full,
    back_quarter))``, NHWC fp32; only the first pair carries gradients.
    ``mark``: a timing hook, called with ``"encoder"``, ``"forward
    decode"`` and ``"backward decode"`` as each part has been issued. In
    fp32 its cuDNN convolutions run without TF32 (``full_fp32_convs``).
    """
    mark = mark or _no_mark
    dev = resolve_device(device)
    x = x.to(dev)
    b = x.shape[0]
    with full_fp32_convs(x.dtype):
        feats = _encode_diff(model, _images(x))
        mark("encoder")
        f1, f2 = [f[:b] for f in feats], [f[b:] for f in feats]
        fwd = _flows(_decode_diff(model, f1, f2))
        mark("forward decode")
        with torch.no_grad():
            fw = prepare(model, x.dtype, dev, q8)
            bwd = _flows(_decode_fused(model, fw, [f.detach() for f in f2],
                                       [f.detach() for f in f1]))
    mark("backward decode")
    return fwd, bwd


def fast_apply_sharded(model, x: torch.Tensor, mesh, q8=None, device=None,
                       diff: bool = False, gather: bool = False):
    """:func:`fast_apply` over the ranks of ``mesh`` (port of ``ocflow_tpu``
    ``fast_apply_sharded``): ``x`` is the global batch ``[B, H, W, 6]``
    (``B`` divisible by the world size), each rank runs the single-GPU
    kernels on its contiguous block and returns its block's flows. The
    model must be replicated (``parallel.replicated``). Feature
    normalization takes its moments over the block, as each device's shard
    does in the JAX package. ``gather=True`` returns the whole batch's
    flows on every rank (serving only: not with ``diff``). Any failure
    raises; nothing falls back to one rank."""
    if diff and gather:
        raise ValueError("fast_apply_sharded: gather is for serving; diff keeps the block")
    out = fast_apply(model, shard_batch(x, mesh), q8=q8, device=device, diff=diff)
    return tuple(mesh.all_gather(o) for o in out) if gather else out


def fast_apply_pair_sharded(model, x: torch.Tensor, mesh, q8=None, device=None,
                            gather: bool = False, mark=None):
    """:func:`fast_apply_pair` over the ranks of ``mesh``, as
    :func:`fast_apply_sharded`: each rank's block of ``x``, its flows (the
    forward pair with gradients), or with ``gather=True`` the whole batch's
    without them."""
    fwd, bwd = fast_apply_pair(model, shard_batch(x, mesh), q8=q8, device=device, mark=mark)
    if gather:
        return tuple(tuple(mesh.all_gather(o) for o in pair) for pair in (fwd, bwd))
    return fwd, bwd


def _no_mark(name: str) -> None:
    pass


def _conv(x, conv: nn.Conv2d, act: bool = True):
    """``conv`` (3x3) with its weights cast to ``x``'s dtype in the graph."""
    y = F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                 stride=conv.stride, padding=conv.padding,
                 dilation=conv.dilation)
    return _leaky(y) if act else y


def _deconv(x, deconv: nn.ConvTranspose2d):
    return F.conv_transpose2d(x, deconv.weight.to(x.dtype),
                              deconv.bias.to(x.dtype), stride=2, padding=1)


def _encode_diff(model: FlowNetCV, img: torch.Tensor) -> list[torch.Tensor]:
    """The feature pyramid under autograd: eager convs (cuDNN), as the JAX
    path runs its plain XLA encoder when gradients flow."""
    feats, h = [], img
    for convs in model.encoder.levels():
        for m in convs:
            h = _conv(h, m)
        feats.append(h)
    return feats


def _diff_group(model: FlowNetCV, i: int, inputs, extra=()):
    """Decoder ``i`` (0 = level 6) as one ``conv_group_diff`` over its
    inputs: the five growth convs, the flow head, then ``extra`` convs
    reading the whole block concat. Weights are reordered (newest first ->
    block order) and cast in the graph. Returns every block."""
    dec = model.decoders[i]
    dt = inputs[0].dtype
    block_ch = [dec.convs()[0].in_channels, *GROWTH]
    convs = [*dec.convs(), *extra]
    ws = [_split_newest_first(c.weight, block_ch[:j + 1]).to(dt)
          for j, c in enumerate(convs)]
    bs = [c.bias.to(dt) for c in convs]
    specs = _decoder_specs(len(inputs), head_emit=True)
    specs += [ConvSpec(tuple(range(len(inputs) + len(GROWTH))), c.out_channels)
              for c in extra]
    return conv_group_diff(inputs, ws, bs, specs)


def _diff_decoder(model: FlowNetCV, i: int, inputs):
    """Levels 6..3: the group, then up-flow and up-feat as transposed convs
    on the flow and on the block concat (newest first)."""
    acts = _diff_group(model, i, inputs)
    deconv, upfeat = model.upsamplers(DECODER_LEVELS[i])
    feat = torch.cat([*acts[len(GROWTH) - 1::-1], *inputs], 1)
    return _deconv(acts[len(GROWTH)], deconv), _deconv(feat, upfeat)


def _diff_level2(model: FlowNetCV, inputs):
    """Level 2: one group with the dense block, the flow head and context
    conv 1; the dilated context convs and the 64 -> 32 -> 2 tail eager."""
    ctx = model.context.convs()
    acts = _diff_group(model, len(DECODER_LEVELS) - 1, inputs, extra=ctx[:1])
    flow, y = acts[len(GROWTH)], acts[len(GROWTH) + 1]
    for m in ctx[1:-1]:
        y = _conv(y, m)
    return flow + _conv(y, ctx[-1], act=False)


def calibrate_q8(model: FlowNetCV, x: torch.Tensor, encoder: bool = False,
                 ctx: bool = False, device=None) -> dict:
    """Static W8A8 calibration (port of ``ocflow_tpu`` ``calibrate_q8``).

    Replays the forward eagerly through ``model``'s own modules on ``x``
    (a representative batch, ``[B, H, W, 6]``, in the model's dtype) and
    records ``max(max|t|, 1e-30) / 127`` of each decoder's input and of
    each growth conv's output: ``{'dec0' .. 'dec4': {'in': s, 'growth':
    [s] * 5}}`` (dec4 is level 2). ``encoder`` adds ``'enc': {'in': s,
    'levels': [[s] * 3] * 6}``, ``ctx`` adds ``'ctx': {'in': s, 'chain':
    [s] * 5}`` (context conv 1's output, then each conv of the chain).
    Scales are Python floats (fp32 values); run once per weight set.
    """
    inputs = {}

    def keep(name):
        return lambda module, args: inputs.__setitem__(name, args[0])

    parts = {f"dec{i}": m for i, m in enumerate(model.decoders)}
    parts.update(ctx=model.context, enc=model.encoder)
    hooks = [m.register_forward_pre_hook(keep(k)) for k, m in parts.items()]
    try:
        with torch.no_grad():
            model(x.to(resolve_device(device)))
    finally:
        for h in hooks:
            h.remove()

    def chain(x, blocks, dense=False):
        """Scales of each block's output, the blocks run in turn (DenseNet:
        each output joins the input, newest first)."""
        out = []
        for blk in blocks:
            y = blk(x)
            out.append(amax_scale(y))
            x = torch.cat([y, x], 1) if dense else y
        return out

    with torch.no_grad():
        scales = {
            k: {"in": amax_scale(inputs[k]), "growth": chain(
                inputs[k], [getattr(dec, f"conv{dec.level}_{j}")
                            for j in range(len(GROWTH))], dense=True)}
            for k, dec in parts.items() if k.startswith("dec")}
        if ctx:
            blocks = [getattr(model, f"dc_conv{j + 1}") for j in range(len(CONTEXT))]
            y = blocks[0](inputs["ctx"])
            scales["ctx"] = {"in": amax_scale(y), "chain": chain(y, blocks[1:])}
        if encoder:
            per_conv = chain(inputs["enc"], list(model.encoder.children()))
            scales["enc"] = {"in": amax_scale(inputs["enc"]), "levels": [
                per_conv[i:i + 3] for i in range(0, len(per_conv), 3)]}
    return scales
