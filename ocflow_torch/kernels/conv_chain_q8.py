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

The int8 stripe's layout is chosen per group at :func:`prepare_group_q8`
(:func:`tma_layout_q8`): a group whose int8-read convs are all of stride 1
and dilation 1 (every decoder group of the W8A8 forward) keeps one
channels-innermost stripe (a ``channels_last`` ``[B, width8, H, W]``
tensor) that holds its inputs too, for ``csrc/conv_group_q8_tma.cu``; the
others (the opt-in ``'enc'`` and ``'ctx'`` groups) keep an NCHW stripe and
their inputs apart. Either way every block is a ``[B, C, H, W]`` view.
``conv_group_q8`` takes the inputs as int8 codes or as values (quantized
with the group's input scale) and makes new stripes for every call
(:func:`stripes_q8`): a channels-innermost group's inputs are quantized, or
copied, into their places there.

On CUDA tensors ``conv_group_q8`` launches one int8 kernel per int8-read
spec (:func:`run_group_q8`): in a channels-innermost group the TMA kernel
(counted in ``conv_group_q8.tma_launches``: a TMA ring, int8 ``wgmma``,
split K on the coarse levels, tiles of :func:`tma_q8_tile`, weights packed
by :func:`pack_tma_weights_q8`), else ``csrc/conv_group_q8.cu`` (counted in
``conv_group_q8.launches``: its staged kernel for a conv of stride 1 and
dilation 1, on the tiles of :func:`staged_tile_q8`, also counted in
``conv_group_q8.staged_launches``; its gather kernel otherwise). A
bf16-read spec launches a bf16 kernel (``conv_group.launches``; the TMA
kernel where ``conv_chain.is_tma`` takes it). There is no fallback from one
kernel to another or to the plain version: the layout and the shapes
decide. On CPU tensors it runs the plain version ``conv_group_q8_plain``,
which computes the integer conv exactly (float64 holds every int32 sum of the path) and the epilogue with
the same fp32 operations in the same order, so the kernel's codes equal it
bit for bit. The TPU kernel's 32-channel padding, lane packing, W-pair
stride-2 packing and im2col/p3 modes are layout devices and have no
counterpart here.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F

from ocflow_torch.kernels import _build
from ocflow_torch.kernels.conv_chain import (COUT_ALIGN, H100_SMS, ConvSpec,
                                             check_kernel_inputs, check_spec, launch_conv,
                                             merge_segments, out_hw, pack_weights,
                                             segment_args, tile_cfg)

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


# The TMA kernel (these match csrc/conv_group_q8_tma.cu): K chunks of
# TMA_Q8_CHUNK stripe channels (one ring stage: a window of 32-byte pixels,
# and weights in K halves of TMA_Q8_KHALF channels), tiles of at most
# TMA_Q8_TILE window pixels in m64 blocks (TMA_Q8_ROW_COLS columns a row in
# rows mode), couts in tiles of one of TMA_Q8_COUT_TILES, a stage of at most
# TMA_Q8_STAGE_MAX bytes whose window carries TMA_Q8_SLACK pixels past it.
TMA_Q8_CHUNK = 32
TMA_Q8_KHALF = 16
TMA_Q8_MAX_CHUNKS = 64
TMA_Q8_TILE = 256
TMA_Q8_ROW_COLS = 64
TMA_Q8_FLAT_MAX_BW = 96
TMA_Q8_COUT_TILES = (8, 16, 32, 64, 96, 128)
TMA_Q8_STAGE_MAX = 53248
TMA_Q8_SLACK = 64


def tma_layout_q8(specs: Sequence[ConvSpec], int8_read: Sequence[bool]) -> bool:
    """Whether a W8A8 group keeps the TMA kernel's channels-innermost int8
    stripe, and every int8-read conv of it runs that kernel: each of them
    of stride 1 and dilation 1 (:func:`is_staged_q8`; any width: the stripe
    has no row alignment to keep). A group with a stride-2 or dilated int8
    conv keeps the NCHW stripe of ``csrc/conv_group_q8.cu`` for all its
    convs."""
    return any(int8_read) and all(
        is_staged_q8(s) for s, r in zip(specs, int8_read, strict=True) if r)


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


def stripe_layout_q8(specs: Sequence[ConvSpec], in_channels: Sequence[int],
                     nhwc: bool):
    """``(in_offsets, offsets, width8, width16)``: each input's channel
    offset in the int8 stripe (``None`` for an NCHW group, whose inputs are
    tensors of their own), each spec's offset in its stripe (int8 for q8
    specs, the bf16 side stripe otherwise) and the two widths. A
    channels-innermost group packs its inputs densely from channel 0 and
    starts each q8 block on a multiple of ``TMA_Q8_CHUNK``, which the width
    is too: a conv's chunks then never reach the block it writes."""
    o8 = o16 = 0
    in_offsets = None
    if nhwc:
        in_offsets = []
        for c in in_channels:
            in_offsets.append(o8)
            o8 += c
        in_offsets = tuple(in_offsets)
    offsets = []
    for s in specs:
        if s.q8:
            o8 = _ceil(o8, TMA_Q8_CHUNK) if nhwc else o8
            offsets.append(o8)
            o8 += s.cout
        else:
            offsets.append(o16)
            o16 += s.cout
    return in_offsets, offsets, _ceil(o8, TMA_Q8_CHUNK) if nhwc else o8, o16


def _read_ranges(spec: ConvSpec, in_offsets, offsets, in_channels, specs):
    """The (stripe offset, channels) of each block ``spec`` reads, in read
    order."""
    n = len(in_channels)
    return [(in_offsets[r], in_channels[r]) if r < n else (offsets[r - n], specs[r - n].cout)
            for r in spec.reads]


@functools.lru_cache(maxsize=None)
def _tma_q8_plan(ranges: tuple[tuple[int, int], ...]):
    """``(chunks, slot)`` of a conv reading the ``(stripe offset, channels)``
    ``ranges`` in order: the first stripe channel of each
    ``TMA_Q8_CHUNK``-channel K chunk, and for each weight input channel its
    row among the chunks' ``len(chunks) * TMA_Q8_CHUNK``. The chunks are
    those that overlap a read block, in stripe order; a channel read a
    second time (a block read twice) lies in a second run of chunks, so
    that no packed weight is a sum of two."""
    ch = torch.cat([torch.arange(o, o + c) for o, c in ranges])
    # occurrence of each column's channel among the earlier columns
    order = torch.argsort(ch, stable=True)
    srt, idx = ch[order], torch.arange(len(ch))
    first = torch.ones(len(ch), dtype=torch.bool)
    first[1:] = srt[1:] != srt[:-1]
    occ = torch.empty_like(ch)
    occ[order] = idx - torch.cummax(torch.where(first, idx, 0), 0).values
    chunks, slot = [], torch.empty_like(ch)
    for layer in range(int(occ.max()) + 1):
        at = occ == layer
        ids = torch.unique(ch[at] // TMA_Q8_CHUNK)
        slot[at] = (len(chunks) + torch.searchsorted(ids, ch[at] // TMA_Q8_CHUNK)) \
            * TMA_Q8_CHUNK + ch[at] % TMA_Q8_CHUNK
        chunks += (ids * TMA_Q8_CHUNK).tolist()
    if len(chunks) > TMA_Q8_MAX_CHUNKS:
        raise ValueError(f"{len(chunks)} K chunks > {TMA_Q8_MAX_CHUNKS}")
    return tuple(chunks), slot


def tma_chunks_q8(ranges) -> tuple[int, ...]:
    """The first stripe channel of each K chunk of a conv reading the
    ``(stripe offset, channels)`` ``ranges`` (:func:`_tma_q8_plan`)."""
    return _tma_q8_plan(tuple(map(tuple, ranges)))[0]


def tma_q8_cout_tile(cout: int) -> tuple[int, int]:
    """``(couts per tile, tiles)``: the smallest of ``TMA_Q8_COUT_TILES``
    that holds ``cout`` (the flow head's 2 in a wgmma n of 8), or tiles of
    128."""
    for n in TMA_Q8_COUT_TILES:
        if cout <= n:
            return n, 1
    return 128, -(-cout // 128)


def pack_tma_weights_q8(wq: torch.Tensor, ranges) -> torch.Tensor:
    """int8 OIHW ``[cout, Cin, 3, 3]`` (input channels in read order) -> the
    TMA kernel's ``[cout tile][chunk][tap][K half][nt couts][TMA_Q8_KHALF]``
    (flat): per chunk and tap the rows of its 32 stripe channels, the
    weight of the read channel there, zero on a channel the conv does not
    read and past ``cout``. ``ranges``: the read blocks' ``(stripe offset,
    channels)`` in read order; the chunks are :func:`tma_chunks_q8`'s."""
    cout, cin = wq.shape[:2]
    nt, ntn = tma_q8_cout_tile(cout)
    chunks, slot = _tma_q8_plan(tuple(map(tuple, ranges)))
    if len(slot) != cin:
        raise ValueError(f"reads of {len(slot)} channels, weight of {cin}")
    col = torch.full((len(chunks) * TMA_Q8_CHUNK,), cin, dtype=torch.long)
    col[slot] = torch.arange(cin)
    w = F.pad(wq.permute(2, 3, 0, 1).reshape(9, cout, cin), (0, 1))  # column cin: zeros
    w = F.pad(w[:, :, col], (0, 0, 0, ntn * nt - cout))
    w = w.reshape(9, ntn, nt, len(chunks), 2, TMA_Q8_KHALF).permute(1, 3, 0, 4, 2, 5)
    return w.contiguous().reshape(-1)


@functools.lru_cache(maxsize=None)
def tma_q8_tile(h: int, w: int) -> tuple[int, int, int, int]:
    """The TMA kernel's tile for an ``h`` x ``w`` output: ``(R rows, C
    columns, mstride, mt)``, its ``mt`` m64 blocks ``mstride`` window
    pixels apart. Rows mode: C = 64, an m64 block a row (mstride = C + 2),
    R <= 4 rows. Flat mode (images at most ``TMA_Q8_FLAT_MAX_BW - 2``
    wide): C = w, the blocks 64 pixels apart over the flat window of R rows
    of ``w + 2`` pixels, R (w + 2) <= 256. The mode that computes fewer
    window pixels per output pixel wins (rows mode on a tie); R balances
    the tiles of a column."""
    def rows(rmax):
        n = -(-h // rmax)
        return n, -(-h // n)

    ny, r = rows(4)
    best = (h * w / (ny * -(-w // TMA_Q8_ROW_COLS) * r * 64),
            (r, TMA_Q8_ROW_COLS, TMA_Q8_ROW_COLS + 2, r))
    bw = w + 2
    if bw <= TMA_Q8_FLAT_MAX_BW:
        ny, r = rows(min(h, TMA_Q8_TILE // bw))
        mt = -(-r * bw // 64)
        if h * w / (ny * mt * 64) > best[0]:
            best = (h * w / (ny * mt * 64), (r, w, 64, mt))
    return best[1]


def tma_q8_units(b: int, h: int, w: int, cout: int) -> int:
    """Work units of one conv before split K: tiles x cout tiles."""
    r, c, _, _ = tma_q8_tile(h, w)
    return b * -(-h // r) * -(-w // c) * tma_q8_cout_tile(cout)[1]


@functools.lru_cache(maxsize=None)
def tma_q8_split(b: int, h: int, w: int, cout: int, nchunk: int) -> int:
    """Blocks that share one unit's K: 1 where the units fill one wave of
    the H100's SMs, else as many as fill it, each with one or more of the
    conv's ``nchunk`` K chunks (one ring stage each)."""
    units = tma_q8_units(b, h, w, cout)
    if units >= H100_SMS:
        return 1
    return max(1, min(H100_SMS // units, nchunk))


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
    packed: list                    # int8-read: pack_weights_q8's [cout_pad, K] int8
                                    # (None in a channels-innermost group: tma8);
                                    # else the bf16 kernel's [9*Cin, cout_pad]
    dq: list                        # int8-read: fp32 [cout] wscale / s_out; else None
    bq: list[torch.Tensor]          # fp32 [cout]: bias / s_out (int8-read) or bias
    offsets: list[int]              # channel offset of each block in its stripe
    width8: int                     # int8 stripe channels
    width16: int                    # bf16 side stripe channels
    # per spec: a bf16-read conv's packings for the TMA kernel, by segment
    # channels (filled at its first launch)
    tma: list[dict] = dataclasses.field(default_factory=list)
    # channels-innermost groups (tma_layout_q8): each input's channel offset
    # in the int8 stripe, and per int8-read spec (pack_tma_weights_q8's
    # packing, its chunks as a ctypes array, their count); None otherwise
    in_offsets: tuple[int, ...] | None = None
    tma8: list | None = None

    @property
    def nhwc(self) -> bool:
        """The int8 stripe is channels-innermost and holds the inputs."""
        return self.in_offsets is not None

    @property
    def n_inputs(self) -> int:
        return len(self.in_channels)

    @property
    def n_int8(self) -> int:
        """Specs that launch an int8 kernel (the others launch the bf16 one)."""
        return sum(self.int8_read)

    @property
    def n_tma8(self) -> int:
        """Specs that launch the int8 TMA kernel."""
        return self.n_int8 if self.nhwc else 0


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
    int8_read = []
    for j, s in enumerate(specs):
        check_spec(s, j, n_in)
        kinds = {q8_block[r] for r in s.reads}
        if len(kinds) != 1:
            raise ValueError(f"conv {j} reads int8 and bf16 blocks at once")
        if s.q8 and kinds != {True}:
            raise ValueError(f"conv {j}: a q8 spec must read the int8 stripe")
        int8_read.append(kinds == {True})
    nhwc = tma_layout_q8(specs, int8_read)
    in_offsets, offsets, width8, width16 = stripe_layout_q8(specs, in_channels, nhwc)
    ws, packed, dqs, bqs = [], [], [], []
    tma8 = [] if nhwc else None
    for j, (w, b, s) in enumerate(zip(weights, biases, specs, strict=True)):
        widths = [_block_channels(specs, in_channels, r) for r in s.reads]
        if tuple(w.shape) != (s.cout, sum(widths), 3, 3):
            raise ValueError(f"conv {j}: weight {tuple(w.shape)}, reads {widths}")
        w = w.detach().to("cpu", torch.float32, copy=True)
        b = b.detach().to("cpu", torch.float32, copy=True)
        if int8_read[j]:
            wq, wscale = fold_quant_weights(
                torch.split(w, widths, 1), [block_scale[r] for r in s.reads])
            s_out = scales[j] if s.q8 else 1.0
            ws.append(wq.to(device))
            if nhwc:
                ranges = _read_ranges(s, in_offsets, offsets, in_channels, specs)
                chunks = tma_chunks_q8(ranges)
                packed.append(None)
                tma8.append((pack_tma_weights_q8(wq, ranges).to(device),
                             (ctypes.c_int * len(chunks))(*chunks), len(chunks)))
            else:
                packed.append(pack_weights_q8(wq, is_staged_q8(s)).to(device))
            dqs.append((wscale / _f32(s_out, wscale)).to(device))
            bqs.append((b / _f32(s_out, b)).to(device))
        else:
            ws.append(w.to(device, torch.bfloat16))
            packed.append(pack_weights(w, torch.bfloat16).to(device))
            dqs.append(None)
            bqs.append(b.to(device))
            if nhwc:
                tma8.append(None)
    return ConvGroupQ8(specs, in_channels, float(in_scale),
                       tuple(float(sc) if s.q8 else None
                             for s, sc in zip(specs, scales)),
                       tuple(int8_read), ws, packed, dqs, bqs, offsets, width8, width16,
                       [{} for _ in specs], in_offsets, tma8)


def _check_inputs(inputs, group: ConvGroupQ8) -> None:
    if len(inputs) != group.n_inputs:
        raise ValueError(
            f"conv_group_q8: {len(inputs)} inputs, group takes {group.n_inputs}")
    dev, b = inputs[0].device, inputs[0].shape[0]
    codes = inputs[0].dtype == torch.int8
    for x, c in zip(inputs, group.in_channels):
        if (x.device != dev or (x.dtype == torch.int8) != codes
                or not (codes or x.is_floating_point()) or x.dim() != 4
                or x.shape[0] != b or x.shape[1] != c):
            raise ValueError(
                f"conv_group_q8: input {tuple(x.shape)} {x.dtype} on {x.device}; "
                f"the group wants int8 codes (or values, all of them) with {c} channels")


def input_codes_q8(inputs: Sequence[torch.Tensor], group: ConvGroupQ8) -> list[torch.Tensor]:
    """The group inputs' int8 codes: int8 inputs as given, values quantized
    with the group's input scale (:func:`quantize_q8`)."""
    return [x if x.dtype == torch.int8 else quantize_q8(x.contiguous(), group.in_scale)
            for x in inputs]


def _new_stripes(group: ConvGroupQ8, b: int, hw: tuple[int, int], dev):
    """An empty int8 stripe (``channels_last`` in a channels-innermost
    group) and bf16 side stripe of ``b`` x ``hw``."""
    fmt = torch.channels_last if group.nhwc else torch.contiguous_format
    s8 = torch.empty((b, group.width8, *hw), dtype=torch.int8, device=dev, memory_format=fmt)
    s16 = torch.empty((b, group.width16, *hw), dtype=torch.bfloat16, device=dev)
    return s8, s16


def _input_views(s8, group: ConvGroupQ8) -> list[torch.Tensor]:
    """The group inputs' places in a channels-innermost stripe."""
    return [s8[:, o:o + c] for o, c in zip(group.in_offsets, group.in_channels)]


@dataclass
class StripesQ8:
    """The blocks of one W8A8 group call (:func:`stripes_q8`): ``inputs``,
    the group inputs' int8 codes (views of ``s8`` in a channels-innermost
    group, else tensors of their own); ``s8``, the int8 stripe; ``s16``,
    the bf16 side stripe."""

    inputs: list[torch.Tensor]
    s8: torch.Tensor
    s16: torch.Tensor


def stripes_q8(inputs: Sequence[torch.Tensor], group: ConvGroupQ8) -> StripesQ8:
    """New stripes for one call of ``group`` on ``inputs`` (int8 codes, or
    values, which it quantizes with the group's input scale). A
    channels-innermost group's inputs are written into their places in the
    new int8 stripe: values quantized there directly, codes copied. Other
    groups keep the inputs' codes apart."""
    inputs = list(inputs)
    x0 = inputs[0]
    hw = out_hw([tuple(x.shape[2:]) for x in inputs], group.specs)
    s8, s16 = _new_stripes(group, x0.shape[0], hw, x0.device)
    if not group.nhwc:
        return StripesQ8(input_codes_q8(inputs, group), s8, s16)
    views = _input_views(s8, group)
    if x0.dtype == torch.int8:
        for v, x in zip(views, inputs):
            v.copy_(x)
    else:
        # quantize_q8 on the inputs' concat, in four launches whatever their
        # number: their places lie side by side from channel 0; dividing by
        # a one-element fp32 tensor promotes bf16 to fp32 as x.float() does
        x = torch.cat(inputs, 1) if len(inputs) > 1 else x0
        q = torch.div(x, _f32(group.in_scale, x))
        s8[:, :sum(group.in_channels)].copy_(q.round_().clamp_(-QMAX, QMAX))
    return StripesQ8(views, s8, s16)


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


def plain_conv_q8(x: torch.Tensor, group: ConvGroupQ8, j: int) -> torch.Tensor:
    """Conv j of ``group`` as the plain version computes it, on ``x``, the
    materialized concat of its reads. int8 reads: the exact integer conv
    (float64), cast to fp32, then the fp32 epilogue as separate multiply
    and add; bf16 reads: an fp32 conv of the bf16 values. Returns its block:
    int8 codes for a q8 spec, bf16 otherwise."""
    s = group.specs[j]
    conv = dict(stride=s.stride, padding=s.dilation, dilation=s.dilation)
    if group.int8_read[j]:
        acc = F.conv2d(x.double(), group.weights[j].double(), **conv).float()
        v = acc * group.dq[j].view(1, -1, 1, 1)
        v = v + group.bq[j].view(1, -1, 1, 1)
    else:
        v = F.conv2d(x.float(), group.weights[j].float(), group.bq[j], **conv)
    if s.act:
        v = torch.where(v >= 0, v, v * 0.1)
    if s.q8:
        return torch.round(v).clamp_(-QMAX, QMAX).to(torch.int8)
    return v.to(torch.bfloat16)


def conv_group_q8_plain(inputs: Sequence[torch.Tensor],
                        group: ConvGroupQ8) -> list[torch.Tensor]:
    """Plain PyTorch version: each conv (:func:`plain_conv_q8`) over the
    materialized concat of its reads, on the inputs' codes (int8 inputs as
    given, values quantized with the group's input scale). Returns the
    emitted blocks (int8 codes for q8 specs, bf16 otherwise)."""
    inputs = list(inputs)
    _check_inputs(inputs, group)
    codes = input_codes_q8(inputs, group)
    hw = out_hw([tuple(x.shape[2:]) for x in codes], group.specs)
    s8, s16 = _new_stripes(group, codes[0].shape[0], hw, codes[0].device)
    for j, s in enumerate(group.specs):
        x = torch.cat([_block(codes, s8, s16, group, r) for r in s.reads], 1)
        _block(codes, s8, s16, group, group.n_inputs + j).copy_(plain_conv_q8(x, group, j))
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


def _tma_lib():
    lib = _build.load("conv_group_q8_tma")
    fn = lib.ocf_conv3x3_q8_tma
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def tma_map_encodes() -> int:
    """Tensor maps the TMA kernels have encoded so far (cache misses): a
    second call with the same shapes and addresses adds none."""
    fn = _build.load("conv_group_q8_tma").ocf_q8_tma_map_encodes
    fn.restype = ctypes.c_longlong
    return fn()


# the split-K workspace of each (device, stream): one s32 buffer, grown as
# needed and reused by every later launch on that stream (stream order keeps
# one launch's partial sums from another's)
_WORKSPACE: dict[tuple, torch.Tensor] = {}


def _workspace(numel: int, device: torch.device, stream: int) -> torch.Tensor:
    key = (device, stream)
    ws = _WORKSPACE.get(key)
    if ws is None or ws.numel() < numel:
        ws = _WORKSPACE[key] = torch.empty(numel, dtype=torch.int32, device=device)
    return ws


def launch_conv_q8_tma(s8: torch.Tensor, group: ConvGroupQ8, j: int,
                       out: torch.Tensor, what: str) -> None:
    """One launch of ``csrc/conv_group_q8_tma.cu`` (and its split-K pass):
    ``out`` (the ``[B, cout, H, W]`` view of spec j's block: int8 in the
    channels-innermost stripe ``s8`` for a q8 spec, else bf16 in the side
    stripe) = the requantized int8 conv of spec j's reads, all in ``s8``.
    Counts the launch in ``conv_group_q8.tma_launches``."""
    s = group.specs[j]
    packed, chunks, nchunk = group.tma8[j]
    b, _, h, w = out.shape
    if out.stride(2) != w * out.stride(3):
        raise ValueError(f"{what}: output rows are not whole pixels apart")
    r, c, mstride, mt = tma_q8_tile(h, w)
    nt, ntn = tma_q8_cout_tile(s.cout)
    split = tma_q8_split(b, h, w, s.cout, nchunk)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    ws = None
    if split > 1:
        ws = _workspace(split * tma_q8_units(b, h, w, s.cout) * TMA_Q8_TILE * nt,
                        out.device, stream).data_ptr()
    code = _tma_lib()(s8.data_ptr(), b, h, w, group.width8, chunks, nchunk,
                      packed.data_ptr(), nt, ntn, group.dq[j].data_ptr(),
                      group.bq[j].data_ptr(), out.data_ptr(), out.stride(0), out.stride(1),
                      out.stride(3), int(s.q8), s.cout, int(s.act), r, c, mstride, mt,
                      split, ws, stream)
    _build.check(code, what)
    conv_group_q8.tma_launches += 1


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


def run_group_q8(st: StripesQ8, group: ConvGroupQ8) -> list[torch.Tensor]:
    """The kernels of a W8A8 chain, one launch per spec, filling the CUDA
    stripes ``st`` (:func:`stripes_q8`) block by block; returns the emitted
    blocks as views of them."""
    if group.nhwc:
        if group.bq[0].device != st.s8.device:
            raise ValueError("conv_group_q8: weights and inputs on different devices")
    else:
        check_kernel_inputs(st.inputs, group.packed[0], "conv_group_q8")
    for j, s in enumerate(group.specs):
        reads = [_block(st.inputs, st.s8, st.s16, group, r) for r in s.reads]
        out = _block(st.inputs, st.s8, st.s16, group, group.n_inputs + j)
        if group.int8_read[j] and group.nhwc:
            launch_conv_q8_tma(st.s8, group, j, out, f"conv_group_q8 conv {j}")
        elif group.int8_read[j]:
            launch_conv_q8(reads, group.packed[j], group.dq[j], group.bq[j], out,
                           s, f"conv_group_q8 conv {j}")
        else:
            launch_conv(reads, group.packed[j], group.bq[j], out, s,
                        f"conv_group_q8 bf16 conv {j}", tma=group.tma[j] if group.tma else None)
    return _emitted(st.s8, st.s16, group)


def conv_group_q8(inputs: Sequence[torch.Tensor],
                  group: ConvGroupQ8) -> list[torch.Tensor]:
    """Run a W8A8 chain on its inputs (int8 codes, or values, which it
    quantizes with the group's input scale); returns the emitted blocks as
    ``[B, cout, Ho, Wo]`` views of new stripes: int8 codes for q8 specs,
    bf16 values otherwise. Kernels on CUDA (:func:`run_group_q8` on
    :func:`stripes_q8`), plain version on the CPU."""
    inputs = list(inputs)
    if inputs[0].device.type == "cpu":
        return conv_group_q8_plain(inputs, group)
    if inputs[0].device.type != "cuda":
        raise ValueError(f"conv_group_q8: unsupported device {inputs[0].device}")
    _check_inputs(inputs, group)
    return run_group_q8(stripes_q8(inputs, group), group)


conv_group_q8.launches = 0
conv_group_q8.staged_launches = 0
conv_group_q8.tma_launches = 0
