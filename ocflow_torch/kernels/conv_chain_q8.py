"""W8A8 conv group: a chain of 3x3 convs over an int8 channel stripe.

Replaces ``ocflow_tpu/ops/pallas/conv_chain_kernel.py:conv_group_q8`` (body
``_q8_kernel_body``, with ``fold_quant_weights`` and ``quantize_q8``). The
group's inputs arrive as int8 codes (``quantize_q8`` with the group's one
input scale). Blocks live in two stripes:

- the **int8 stripe** holds the codes of the ``q8`` specs;
- the **bf16 side stripe** holds the outputs of the other specs (the flow
  head, the context conv, the phase convs), already de-scaled.

A spec reads blocks of one stripe only. Reading int8 blocks it is an
int8 x int8 -> int32 GEMM whose weight carries the read blocks' activation
scales, folded in per read and quantized per output channel
(:func:`fold_quant_weights`); its epilogue is, in fp32, with no fused
multiply-add::

    v = float(acc) * (wscale / s_out) + bias / s_out
    v = v if v >= 0 else v * 0.1          (if act)
    q8 spec: code = clip(round_half_even(v), -127, 127)   else: bf16(v)

with ``s_out = 1`` for a non-q8 spec. Reading bf16 blocks (the up-flow
phase conv reads the flow head) it is a plain bf16 conv with fp32
accumulation, launched on the bf16 conv-group kernel of
``kernels/conv_chain.py``.

On CUDA tensors ``conv_group_q8`` launches ``csrc/conv_group_q8.cu`` once
per int8-read spec (``conv_group_q8.launches``; a conv of stride 1 and
dilation 1 runs its staged kernel, on the tiles of :func:`staged_tile_q8`,
and ``conv_group_q8.staged_launches`` counts those too) and a bf16 kernel
once per bf16-read spec (``conv_group.launches``; the TMA kernel where
``conv_chain.is_tma`` takes it); on CPU tensors it runs
the plain version ``conv_group_q8_plain``, which computes the integer conv
exactly (float64 holds every int32 sum of the path) and the epilogue with
the same fp32 operations in the same order, so the kernel's codes equal it
bit for bit. The TPU kernel's 32-channel padding, lane packing, W-pair
stride-2 packing and im2col/p3 modes are layout devices and have no
counterpart here.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F

from ocflow_torch.kernels import _build
from ocflow_torch.kernels.conv_chain import (COUT_ALIGN, ConvSpec, check_kernel_inputs,
                                             check_spec, launch_conv, merge_segments,
                                             out_hw, pack_weights, segment_args,
                                             tile_cfg)

QMAX = 127
SCALE_FLOOR = 1e-30  # a degenerate (all-zero) tensor must not give scale 0
_K_ALIGN = 32        # packed K padding: the kernel's K step

# The staged int8 kernel's tile (these match csrc/conv_group_q8.cu's ST_*
# and BN): at most STAGE_Q8_PIXELS output pixels, C a multiple of
# STAGE_Q8_ALIGN; per chunk of STAGE_Q8_CHUNK input channels a halo tile
# [STAGE_Q8_CHUNK][R + 2][C + STAGE_Q8_EXTRA] bytes, its plane at most
# STAGE_Q8_PLANE_MAX.
STAGE_Q8_PIXELS = 128
STAGE_Q8_ALIGN = 16
STAGE_Q8_CHUNK = 32
STAGE_Q8_EXTRA = 32
STAGE_Q8_PLANE_MAX = 480


def is_staged_q8(spec: ConvSpec) -> bool:
    """Whether an int8-read conv runs the staged kernel: stride 1, dilation 1."""
    return spec.stride == 1 and spec.dilation == 1


def staged_tile_q8(wo: int) -> tuple[int, int]:
    """The staged int8 kernel's output tile, ``(rows R, columns C)``, for an
    output ``Wo`` wide: a whole row of up to 128 pixels, rounded up to a
    multiple of 16 (a 16-byte vector holds 16 int8 pixels), and as many rows
    as fill 128 pixels: 1x128 at 128 or more, 2x64, 4x32, 8x16. A tile never
    straddles two images; the kernel masks rows past ``Ho`` and columns past
    ``Wo``."""
    c = min(-(-wo // STAGE_Q8_ALIGN) * STAGE_Q8_ALIGN, STAGE_Q8_PIXELS)
    return STAGE_Q8_PIXELS // c, c


def pack_weights_q8(wq: torch.Tensor, staged: bool) -> torch.Tensor:
    """int8 OIHW ``[cout, Cin, 3, 3]`` -> the int8 kernel's ``[cout_pad,
    K]``, zero past ``cout``. Staged convs: ``K = 9 * Cin32`` (Cin rounded
    up to 32), row co holding ``k = tap*Cin32 + c``, zero for c >= Cin, so
    the 32 K bytes of each (tap, channel chunk) are two aligned 16-byte
    vectors. Gather convs: ``k = tap*Cin + c``, zero past ``9*Cin`` up to a
    multiple of 32."""
    cout, cin = wq.shape[:2]
    cout_pad = -(-cout // COUT_ALIGN) * COUT_ALIGN
    wk = wq.permute(0, 2, 3, 1).reshape(cout, 9, cin)
    if staged:
        wk = F.pad(wk, (0, -(-cin // _K_ALIGN) * _K_ALIGN - cin)).reshape(cout, -1)
    else:
        wk = wk.reshape(cout, 9 * cin)
        wk = F.pad(wk, (0, -(-9 * cin // _K_ALIGN) * _K_ALIGN - 9 * cin))
    return F.pad(wk, (0, 0, 0, cout_pad - cout)).contiguous()


def _f32(s, like: torch.Tensor) -> torch.Tensor:
    """A scale as a one-element fp32 tensor beside ``like``: dividing by a
    tensor is a true division on every device (a Python scalar divisor
    becomes a multiply by its reciprocal on CUDA)."""
    return torch.full((1,), float(s), dtype=torch.float32, device=like.device)


def quantize_q8(x: torch.Tensor, scale) -> torch.Tensor:
    """value -> int8 code: ``clip(round(x / scale), -127, 127)`` in fp32,
    round half to even (symmetric, zero point 0)."""
    q = torch.round(x.float() / _f32(scale, x))
    return q.clamp_(-QMAX, QMAX).to(torch.int8)


def dequantize_q8(codes: torch.Tensor, scale, dtype: torch.dtype) -> torch.Tensor:
    """int8 codes -> ``codes * scale`` in ``dtype`` (one rounding, from fp32)."""
    return (codes.float() * _f32(scale, codes)).to(dtype)


def amax_scale(t: torch.Tensor) -> float:
    """The calibration scale ``max(max|t|, 1e-30) / 127`` of a tensor."""
    m = t.float().abs().amax().reshape(1).clamp(min=SCALE_FLOOR)
    return float(m / _f32(QMAX, m))


def fold_quant_weights(w_list: Sequence[torch.Tensor], read_scales):
    """Fold each read block's activation scale into its fp32 weight, concat
    over the input channels, quantize per output channel.

    ``w_list[i]``: OIHW ``[cout, C_i, 3, 3]``, the weight over read block
    i; ``read_scales[i]``: that block's scale. Returns ``(wq [cout, sum C_i,
    3, 3] int8, wscale [cout] fp32)`` with ``w_i ~ wq * wscale / s_i``.
    """
    wf = torch.cat([w.float() * _f32(s, w) for w, s in
                    zip(w_list, read_scales, strict=True)], 1)
    wmax = wf.abs().amax(dim=(1, 2, 3))
    wscale = wmax.clamp(min=SCALE_FLOOR) / _f32(QMAX, wmax)
    wq = torch.round(wf / wscale[:, None, None, None]).clamp_(-QMAX, QMAX)
    return wq.to(torch.int8), wscale


@dataclass
class ConvGroupQ8:
    """A W8A8 chain with its weights folded and packed once (see
    :func:`prepare_group_q8`)."""

    specs: tuple[ConvSpec, ...]
    in_channels: tuple[int, ...]    # channels of each group input
    in_scale: float                 # the scale of every group input
    scales: tuple                   # per spec: output scale (q8) or None
    int8_read: tuple[bool, ...]     # per spec: reads the int8 stripe
    weights: list[torch.Tensor]     # int8-read: wq OIHW int8; else OIHW bf16
    packed: list[torch.Tensor]      # int8-read: pack_weights_q8's [cout_pad, K] int8;
                                    # else the bf16 kernel's [9*Cin, cout_pad]
    dq: list                        # int8-read: fp32 [cout] wscale / s_out; else None
    bq: list[torch.Tensor]          # fp32 [cout]: bias / s_out (int8-read) or bias
    offsets: list[int]              # channel offset of each block in its stripe
    width8: int                     # int8 stripe channels
    width16: int                    # bf16 side stripe channels
    # per spec: a bf16-read conv's packings for the TMA kernel, by segment
    # channels (filled at its first launch)
    tma: list[dict] = dataclasses.field(default_factory=list)

    @property
    def n_inputs(self) -> int:
        return len(self.in_channels)

    @property
    def n_int8(self) -> int:
        """Specs that launch the int8 kernel (the others launch the bf16 one)."""
        return sum(self.int8_read)


def _block_channels(group_specs, in_channels, bid: int) -> int:
    n = len(in_channels)
    return in_channels[bid] if bid < n else group_specs[bid - n].cout


def prepare_group_q8(weights: Sequence[torch.Tensor],
                     biases: Sequence[torch.Tensor],
                     specs: Sequence[ConvSpec], in_channels: Sequence[int],
                     in_scale, scales: Sequence, device) -> ConvGroupQ8:
    """Fold, quantize and pack a W8A8 chain's weights.

    weights[j]: OIHW ``[cout_j, Cin_j, 3, 3]`` whose input channels are the
    concat of ``specs[j].reads`` in read order (the fp32 values of the
    model's weights); biases[j]: ``[cout_j]``. ``in_scale`` quantizes every
    group input; ``scales[j]`` is spec j's output scale (q8 specs; ignored
    otherwise). Folding runs on the CPU in fp32; the packed tensors then
    move to ``device``.
    """
    specs = tuple(specs)
    in_channels = tuple(int(c) for c in in_channels)
    n_in = len(in_channels)
    q8_block = [True] * n_in + [s.q8 for s in specs]
    block_scale = [in_scale] * n_in + [
        sc if s.q8 else None for s, sc in zip(specs, scales, strict=True)]
    ws, packed, dqs, bqs, offsets, int8_read = [], [], [], [], [], []
    o8 = o16 = 0
    for j, (w, b, s) in enumerate(zip(weights, biases, specs, strict=True)):
        check_spec(s, j, n_in)
        widths = [_block_channels(specs, in_channels, r) for r in s.reads]
        if tuple(w.shape) != (s.cout, sum(widths), 3, 3):
            raise ValueError(f"conv {j}: weight {tuple(w.shape)}, reads {widths}")
        kinds = {q8_block[r] for r in s.reads}
        if len(kinds) != 1:
            raise ValueError(f"conv {j} reads int8 and bf16 blocks at once")
        w = w.detach().to("cpu", torch.float32, copy=True)
        b = b.detach().to("cpu", torch.float32, copy=True)
        if kinds == {True}:
            wq, wscale = fold_quant_weights(
                torch.split(w, widths, 1), [block_scale[r] for r in s.reads])
            s_out = scales[j] if s.q8 else 1.0
            ws.append(wq.to(device))
            packed.append(pack_weights_q8(wq, is_staged_q8(s)).to(device))
            dqs.append((wscale / _f32(s_out, wscale)).to(device))
            bqs.append((b / _f32(s_out, b)).to(device))
            int8_read.append(True)
        else:
            if s.q8:
                raise ValueError(f"conv {j}: a q8 spec must read the int8 stripe")
            ws.append(w.to(device, torch.bfloat16))
            packed.append(pack_weights(w, torch.bfloat16).to(device))
            dqs.append(None)
            bqs.append(b.to(device))
            int8_read.append(False)
        if s.q8:
            offsets.append(o8)
            o8 += s.cout
        else:
            offsets.append(o16)
            o16 += s.cout
    return ConvGroupQ8(specs, in_channels, float(in_scale),
                       tuple(float(sc) if s.q8 else None
                             for s, sc in zip(specs, scales)),
                       tuple(int8_read), ws, packed, dqs, bqs, offsets, o8, o16,
                       [{} for _ in specs])


def _check_inputs(inputs, group: ConvGroupQ8) -> None:
    if len(inputs) != group.n_inputs:
        raise ValueError(
            f"conv_group_q8: {len(inputs)} inputs, group takes {group.n_inputs}")
    dev, b = inputs[0].device, inputs[0].shape[0]
    for x, c in zip(inputs, group.in_channels):
        if (x.device != dev or x.dtype != torch.int8 or x.dim() != 4
                or x.shape[0] != b or x.shape[1] != c):
            raise ValueError(
                f"conv_group_q8: input {tuple(x.shape)} {x.dtype} on {x.device}; "
                f"the group wants int8 codes with {c} channels")


def _stripes(inputs, group: ConvGroupQ8):
    ho, wo = out_hw([tuple(x.shape[2:]) for x in inputs], group.specs)
    b, dev = inputs[0].shape[0], inputs[0].device
    s8 = torch.empty((b, group.width8, ho, wo), dtype=torch.int8, device=dev)
    s16 = torch.empty((b, group.width16, ho, wo), dtype=torch.bfloat16,
                      device=dev)
    return s8, s16


def _block(inputs, s8, s16, group: ConvGroupQ8, bid: int) -> torch.Tensor:
    if bid < group.n_inputs:
        return inputs[bid]
    j = bid - group.n_inputs
    o, s = group.offsets[j], group.specs[j]
    return (s8 if s.q8 else s16)[:, o:o + s.cout]


def _emitted(s8, s16, group: ConvGroupQ8) -> list[torch.Tensor]:
    n = group.n_inputs
    return [_block(None, s8, s16, group, n + j)
            for j, s in enumerate(group.specs) if s.emit]


def conv_group_q8_plain(inputs: Sequence[torch.Tensor],
                        group: ConvGroupQ8) -> list[torch.Tensor]:
    """Plain PyTorch version: each conv over the materialized concat of its
    reads. int8 reads: the exact integer conv (float64), cast to fp32, then
    the fp32 epilogue as separate multiply and add. bf16 reads: an fp32
    conv of the bf16 values. Returns the emitted blocks (int8 codes for q8
    specs, bf16 otherwise)."""
    inputs = list(inputs)
    _check_inputs(inputs, group)
    s8, s16 = _stripes(inputs, group)
    for j, s in enumerate(group.specs):
        x = torch.cat([_block(inputs, s8, s16, group, r) for r in s.reads], 1)
        conv = dict(stride=s.stride, padding=s.dilation, dilation=s.dilation)
        if group.int8_read[j]:
            acc = F.conv2d(x.double(), group.weights[j].double(), **conv).float()
            v = acc * group.dq[j].view(1, -1, 1, 1)
            v = v + group.bq[j].view(1, -1, 1, 1)
        else:
            v = F.conv2d(x.float(), group.weights[j].float(), group.bq[j], **conv)
        if s.act:
            v = torch.where(v >= 0, v, v * 0.1)
        out = _block(inputs, s8, s16, group, group.n_inputs + j)
        if s.q8:
            out.copy_(torch.round(v).clamp_(-QMAX, QMAX).to(torch.int8))
        else:
            out.copy_(v.to(torch.bfloat16))
    return _emitted(s8, s16, group)


def _lib():
    lib = _build.load("conv_group_q8")
    fn = lib.ocf_conv3x3_q8
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def launch_conv_q8(reads: Sequence[torch.Tensor], packed: torch.Tensor,
                   dq: torch.Tensor, bq: torch.Tensor, out: torch.Tensor,
                   spec: ConvSpec, what: str) -> None:
    """One launch of ``csrc/conv_group_q8.cu``: ``out`` (a ``[B, cout, Ho,
    Wo]`` channel range of a stripe: int8 for a q8 spec, else bf16) = the
    requantized int8 conv of the channel concat of the int8 ``reads`` with
    ``packed`` (see :func:`pack_weights_q8`), ``dq`` and ``bq``. Counts the
    launch in ``conv_group_q8.launches`` (and, on the staged kernel, in
    ``conv_group_q8.staged_launches``)."""
    segs = merge_segments(reads)
    ptrs, bstr, chans = segment_args(segs)
    b, _, ho, wo = out.shape
    hin, win = segs[0].shape[2:]
    stream = torch.cuda.current_stream(out.device).cuda_stream
    code = _lib()(tile_cfg(spec.cout), len(segs), ptrs, bstr, chans, b, hin,
                  win, packed.data_ptr(), packed.shape[1], packed.shape[0],
                  dq.data_ptr(), bq.data_ptr(), out.data_ptr(), out.stride(0),
                  int(spec.q8), spec.cout, ho, wo, spec.stride, spec.dilation,
                  int(spec.act), *staged_tile_q8(wo), stream)
    _build.check(code, what)
    conv_group_q8.launches += 1
    if is_staged_q8(spec):
        conv_group_q8.staged_launches += 1


def conv_group_q8(inputs: Sequence[torch.Tensor],
                  group: ConvGroupQ8) -> list[torch.Tensor]:
    """Run a W8A8 chain on int8 input codes; returns the emitted blocks as
    ``[B, cout, Ho, Wo]`` views of the stripes: int8 codes for q8 specs,
    bf16 values otherwise. Kernels on CUDA, plain version on the CPU."""
    inputs = list(inputs)
    if inputs[0].device.type == "cpu":
        return conv_group_q8_plain(inputs, group)
    if inputs[0].device.type != "cuda":
        raise ValueError(f"conv_group_q8: unsupported device {inputs[0].device}")
    _check_inputs(inputs, group)
    check_kernel_inputs(inputs, group.packed[0], "conv_group_q8")
    s8, s16 = _stripes(inputs, group)
    for j, s in enumerate(group.specs):
        reads = [_block(inputs, s8, s16, group, r) for r in s.reads]
        out = _block(inputs, s8, s16, group, group.n_inputs + j)
        if group.int8_read[j]:
            launch_conv_q8(reads, group.packed[j], group.dq[j], group.bq[j], out,
                           s, f"conv_group_q8 conv {j}")
        else:
            launch_conv(reads, group.packed[j], group.bq[j], out, s,
                        f"conv_group_q8 bf16 conv {j}", tma=group.tma[j] if group.tma else None)
    return _emitted(s8, s16, group)


conv_group_q8.launches = 0
conv_group_q8.staged_launches = 0
