"""Conv group: a chain of 3x3 convs over one shared channel stripe.

Replaces ``ocflow_tpu/ops/pallas/conv_chain_kernel.py:conv_group``. Each
group owns one stripe ``[B, sum(cout), Ho, Wo]`` in which every conv of the
chain writes its output at a fixed channel offset. A conv reads its
``reads`` (block ids: ``0..n_inputs-1`` are the group's inputs, ``n_inputs
+ j`` is conv j's output) as channel ranges of the inputs or the stripe,
so a DenseNet concat is never built. Each conv applies bias and optional
LeakyReLU(0.1) and stores in the group's dtype (fp32 or bf16); later convs
read the stored values, as the TPU kernel reads its VMEM stripe.

On CUDA tensors ``conv_group`` launches one kernel per conv
(``conv_group.launches`` counts the launches). A bf16 conv of stride 1 and
dilation 1 (:func:`is_staged`; ``conv_group.staged_launches`` counts those)
runs ``csrc/conv_group_tma.cu`` where :func:`is_tma` takes its shape
(``conv_group.tma_launches``: a TMA ring and wgmma, split K on the coarse
levels, weights packed by :func:`pack_tma_weights`), else the staged kernel
of ``csrc/conv_group.cu`` on the tiles of :func:`staged_tile`; every other
conv runs ``csrc/conv_group.cu``'s gather or fp32 kernel. On CPU tensors it
runs the plain version ``conv_group_plain``. There is no fallback from one
kernel to another, or to the plain version: the routing is decided by
shape. The TPU kernel's lane packing, W-pair stride-2 packing, im2col and
16-channel padding are TPU layout devices and have no counterpart here: a
stride-2 conv reads its (unpacked) input directly.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.nn.functional as F

from ocflow_torch import full_fp32_convs
from ocflow_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAXSEG = 8
COUT_ALIGN = 128  # packed cout padding: a multiple of every kernel tile


@dataclass(frozen=True)
class ConvSpec:
    """One 3x3 conv of a group.

    reads: block ids it consumes, in the order of its weight's input
        channels. cout: output channels. dilation: tap spacing (padding
        equals the dilation). act: LeakyReLU(0.1). emit: return this
        conv's output. stride: 1, or 2 for a conv that reads one group
        input at twice the group's resolution. q8: store this conv's
        output as int8 codes (W8A8 groups only, ``kernels.conv_chain_q8``).
    """

    reads: tuple[int, ...]
    cout: int
    dilation: int = 1
    act: bool = True
    emit: bool = False
    stride: int = 1
    q8: bool = False


@dataclass
class ConvGroup:
    """A chain with its weights packed once (see :func:`prepare_group`)."""

    specs: tuple[ConvSpec, ...]
    n_inputs: int
    weights: list[torch.Tensor]  # per conv: OIHW over its reads (plain version)
    biases: list[torch.Tensor]   # per conv: fp32 [cout] (both versions)
    packed: list[torch.Tensor]   # per conv: [9*Cin, cout_pad], k = tap*Cin + c
    offsets: list[int]           # stripe channel offset of each conv's block
    width: int                   # stripe channels
    dtype: torch.dtype
    # per conv: the TMA kernel's packing, by the channel counts of the
    # segments it was packed for (pack_tma_weights; filled on first use)
    tma: list[dict] = dataclasses.field(default_factory=list)


def prepare_group(weights: Sequence[torch.Tensor],
                  biases: Sequence[torch.Tensor],
                  specs: Sequence[ConvSpec], n_inputs: int,
                  dtype: torch.dtype, device,
                  in_channels: Sequence[int] | None = None) -> ConvGroup:
    """Pack a chain's weights for the kernel.

    weights[j]: ``[cout_j, Cin_j, 3, 3]`` (OIHW) whose input channels are
    the concatenation of ``specs[j].reads`` in read order; biases[j]:
    ``[cout_j]``. On a CUDA device with ``in_channels`` (the inputs'
    channel counts) the bf16 convs of stride 1 and dilation 1 are also
    packed for the TMA kernel here, for the segments :func:`tma_segments`
    predicts; otherwise (or for other segments) at their first launch.
    """
    specs = tuple(specs)
    if dtype not in _DTYPES:
        raise ValueError(f"conv_group: unsupported dtype {dtype}")
    ws, bs, packed, offsets = [], [], [], []
    off = 0
    for j, (w, b, s) in enumerate(zip(weights, biases, specs, strict=True)):
        if w.shape[0] != s.cout or tuple(w.shape[2:]) != (3, 3):
            raise ValueError(f"conv {j}: weight {tuple(w.shape)} vs cout {s.cout}")
        check_spec(s, j, n_inputs)
        if s.q8:
            raise ValueError(f"conv {j}: q8 specs belong to a W8A8 group")
        # copies: the group is a snapshot, even of fp32 weights on the same
        # device (an optimizer step must not reach its plain-version weights)
        w = w.detach().to(device=device, dtype=torch.float32, copy=True)
        b = b.detach().to(device=device, dtype=torch.float32, copy=True)
        packed.append(pack_weights(w, dtype))
        ws.append(w.to(dtype))
        bs.append(b.contiguous())
        offsets.append(off)
        off += s.cout
    tma = [{} for _ in specs]
    if in_channels is not None and torch.device(device).type == "cuda":
        for j, s in enumerate(specs):
            if is_staged(dtype, s):
                chans = tma_segments(s, in_channels, specs)
                tma[j][chans] = pack_tma_weights(packed[j], chans, s.cout)
    return ConvGroup(specs, n_inputs, ws, bs, packed, offsets, off, dtype, tma)


def check_spec(s: ConvSpec, j: int, n_inputs: int) -> None:
    """Reads of earlier blocks only; stride 2 reads exactly one input."""
    if any(r >= n_inputs + j for r in s.reads):
        raise ValueError(f"conv {j} reads a block produced later: {s.reads}")
    if s.stride not in (1, 2) or (s.stride == 2 and (
            len(s.reads) != 1 or s.reads[0] >= n_inputs)):
        raise ValueError(f"conv {j}: stride 2 reads exactly one group input")


def pack_weights(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """OIHW ``[cout, Cin, 3, 3]`` -> the bf16/fp32 kernel's ``[9*Cin,
    cout_pad]``, row ``k = tap*Cin + c``."""
    cout, cin = w.shape[:2]
    cout_pad = -(-cout // COUT_ALIGN) * COUT_ALIGN
    wk = w.permute(2, 3, 1, 0).reshape(9 * cin, cout)
    return F.pad(wk, (0, cout_pad - cout)).to(dtype).contiguous()


def out_hw(hw: list, specs) -> tuple[int, int]:
    """The stripe's spatial size from the inputs' ``hw``, checked against
    every conv's reads."""
    hw = list(hw)
    out = None
    for j, s in enumerate(specs):
        src = {hw[r] for r in s.reads}
        if len(src) != 1:
            raise ValueError(f"conv {j} reads blocks of sizes {src}")
        (h, w), = src
        if s.stride == 2:
            h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
        if out is not None and (h, w) != out:
            raise ValueError(f"conv {j} outputs {(h, w)}, the group {out}")
        out = (h, w)
        hw.append(out)
    return out


def _out_hw(inputs, group: ConvGroup) -> tuple[int, int]:
    return out_hw([tuple(x.shape[2:]) for x in inputs], group.specs)


def _block(inputs, stripe, group: ConvGroup, bid: int) -> torch.Tensor:
    if bid < group.n_inputs:
        return inputs[bid]
    j = bid - group.n_inputs
    o = group.offsets[j]
    return stripe[:, o:o + group.specs[j].cout]


def _emitted(stripe, group: ConvGroup) -> list[torch.Tensor]:
    return [stripe[:, o:o + s.cout]
            for s, o in zip(group.specs, group.offsets) if s.emit]


def _check_inputs(inputs, group: ConvGroup) -> None:
    if len(inputs) != group.n_inputs:
        raise ValueError(f"conv_group: {len(inputs)} inputs, group takes {group.n_inputs}")
    dev = inputs[0].device
    b = inputs[0].shape[0]
    for x in inputs:
        if x.device != dev or x.dtype != group.dtype or x.dim() != 4 or x.shape[0] != b:
            raise ValueError(
                f"conv_group: input {tuple(x.shape)} {x.dtype} on {x.device}; "
                f"the group wants {group.dtype}")
    for j, (s, w) in enumerate(zip(group.specs, group.weights)):
        cin = sum(inputs[r].shape[1] if r < group.n_inputs
                  else group.specs[r - group.n_inputs].cout for r in s.reads)
        if cin != w.shape[1]:
            raise ValueError(f"conv {j}: reads {cin} channels, weight wants {w.shape[1]}")


def conv_group_plain(inputs: Sequence[torch.Tensor],
                     group: ConvGroup) -> list[torch.Tensor]:
    """Plain PyTorch version: each conv over the materialized concat of its
    reads, computed in fp32 and stored in the group dtype."""
    _check_inputs(inputs, group)
    h, w = _out_hw(inputs, group)
    x0 = inputs[0]
    stripe = torch.empty((x0.shape[0], group.width, h, w), dtype=group.dtype,
                         device=x0.device)
    for j, s in enumerate(group.specs):
        x = torch.cat([_block(inputs, stripe, group, r) for r in s.reads], 1)
        y = F.conv2d(x.float(), group.weights[j].float(),
                     group.biases[j], stride=s.stride,
                     padding=s.dilation, dilation=s.dilation)
        if s.act:
            y = F.leaky_relu(y, 0.1)
        o = group.offsets[j]
        stripe[:, o:o + s.cout] = y.to(group.dtype)
    return _emitted(stripe, group)


def _lib():
    lib = _build.load("conv_group")
    fn = lib.ocf_conv3x3
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def merge_segments(views: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """A conv's reads as channel segments for the kernels: consecutive
    views that are adjacent channel ranges of one tensor (stripe blocks)
    merge into one segment."""
    segs: list[torch.Tensor] = []
    for t in views:
        if segs:
            p = segs[-1]
            if (p.untyped_storage().data_ptr()
                    == t.untyped_storage().data_ptr()
                    and p.dtype == t.dtype and p.stride() == t.stride()
                    and p.shape[2:] == t.shape[2:]
                    and t.data_ptr() == p.data_ptr()
                    + p.shape[1] * p.stride(1) * p.element_size()):
                segs[-1] = p.as_strided(
                    (p.shape[0], p.shape[1] + t.shape[1], *p.shape[2:]),
                    p.stride())
                continue
        segs.append(t)
    if len(segs) > _MAXSEG:
        raise ValueError(f"{len(segs)} channel segments > {_MAXSEG}")
    return segs


def segment_args(segs: Sequence[torch.Tensor]):
    """ctypes arrays of the segments' pointers, batch strides, channels."""
    n = len(segs)
    return ((ctypes.c_void_p * n)(*[t.data_ptr() for t in segs]),
            (ctypes.c_longlong * n)(*[t.stride(0) for t in segs]),
            (ctypes.c_int * n)(*[t.shape[1] for t in segs]))


def tile_cfg(cout: int) -> int:
    """Output channels per kernel tile: 16 << cfg."""
    return 0 if cout <= 16 else 1 if cout <= 32 else 2 if cout <= 64 else 3


# The staged kernel's tile (these match csrc/conv_group.cu's ST_* and TC_*):
# at most STAGE_PIXELS output pixels, at most STAGE_MAX_ROWS rows; per chunk
# of STAGE_CHUNK input channels a halo tile [STAGE_CHUNK][R + 2][C +
# STAGE_EXTRA] in STAGE_HALO bf16 elements of shared memory.
STAGE_PIXELS = 128
STAGE_MAX_ROWS = 16
STAGE_CHUNK = 32
STAGE_EXTRA = 16
STAGE_HALO = STAGE_CHUNK * 432


def is_staged(dtype: torch.dtype, spec: ConvSpec) -> bool:
    """Whether a conv runs the staged kernel: bf16, stride 1, dilation 1."""
    return dtype == torch.bfloat16 and spec.stride == 1 and spec.dilation == 1


def staged_tile(wo: int) -> tuple[int, int]:
    """The staged kernel's output tile, ``(rows R, columns C)``, for an
    output ``Wo`` wide: a whole row of up to 128 pixels, rounded up to a
    multiple of 8 (the kernel copies 8 columns at a time), and as many rows
    as fill 128 pixels (at most 16): 1x128 at 128 or more, 2x64, 4x32,
    8x16. A tile never straddles two images; the kernel masks rows past
    ``Ho`` and columns past ``Wo``."""
    c = min(-(-wo // 8) * 8, STAGE_PIXELS)
    return min(STAGE_PIXELS // c, STAGE_MAX_ROWS), c


# The TMA kernel (these match csrc/conv_group_tma.cu): tiles of TMA_TILE
# output pixels, TMA_CHUNK input channels of one segment per K chunk (one
# stage of its ring and one TMA box; a segment's last chunk is zero-filled
# past its end), couts in tiles of one of TMA_COUT_TILES.
TMA_TILE = 256
TMA_CHUNK = 16
TMA_MAX_CHUNKS = 64
TMA_COUT_TILES = (16, 32, 64, 96, 128)
H100_SMS = 132          # one wave of blocks on the H100 (split-K's target)


def is_tma(dtype: torch.dtype, spec: ConvSpec, hw: tuple[int, int]) -> bool:
    """Whether a conv whose output is ``hw = (H, W)`` runs the TMA kernel:
    bf16, stride 1, dilation 1, and rows whose pitch (``W`` bf16) is a
    multiple of 16 bytes, as TMA wants of every stride (the segments' base
    addresses must be 16-byte aligned too: the launch checks them). Any
    cout and any Cin: the card measured it faster than the staged kernel on
    every such conv of the forward and the step (PERF.md). Every other conv
    stays on ``csrc/conv_group.cu``: KITTI's 320x1216 levels of width 76, 38
    and 19 on the staged kernel."""
    return is_staged(dtype, spec) and hw[1] % 8 == 0


def tma_tile_cols(w: int) -> int:
    """Tile columns C (``TMA_TILE // C`` rows): 64 bf16 (a 128-byte
    swizzle span), or 32 / 16 where the image is no wider."""
    return 16 if w <= 16 else 32 if w <= 32 else 64


def tma_cout_tile(cout: int) -> tuple[int, int]:
    """``(couts per tile, tiles)``: the smallest wgmma n of
    ``TMA_COUT_TILES`` that holds ``cout``, or tiles of 128."""
    for n in TMA_COUT_TILES:
        if cout <= n:
            return n, 1
    return 128, -(-cout // 128)


@functools.lru_cache(maxsize=None)
def _tma_plan(chans: tuple[int, ...]):
    """The chunk codes of segments of ``chans`` channels as the C entry
    point takes them (a ctypes array, never written)."""
    chunks = tma_chunks(chans)
    return (ctypes.c_int * len(chunks))(*[seg | c0 << 3 for seg, c0 in chunks]), len(chunks)


def tma_chunks(chans: Sequence[int]) -> list[tuple[int, int]]:
    """The K chunks of a conv over segments of ``chans`` channels, in
    order: ``(segment, first channel)``, ``TMA_CHUNK`` channels each."""
    out = [(s, c0) for s, c in enumerate(chans) for c0 in range(0, c, TMA_CHUNK)]
    if len(out) > TMA_MAX_CHUNKS:
        raise ValueError(f"{len(out)} K chunks > {TMA_MAX_CHUNKS}")
    return out


def tma_units(b: int, h: int, w: int, cout: int) -> int:
    """Work units of one conv before split K: tiles x cout tiles."""
    tc = tma_tile_cols(w)
    return b * -(-h // (TMA_TILE // tc)) * -(-w // tc) * tma_cout_tile(cout)[1]


@functools.lru_cache(maxsize=None)
def tma_split(b: int, h: int, w: int, cout: int, nchunk: int) -> int:
    """Blocks that share one unit's K: 1 where the units fill one wave of
    the H100's SMs, else as many as fill it, each with one or more of the
    conv's ``nchunk`` K chunks (one ring stage each)."""
    units = tma_units(b, h, w, cout)
    if units >= H100_SMS:
        return 1
    return max(1, min(H100_SMS // units, nchunk))


def tma_segments(spec: ConvSpec, in_channels: Sequence[int],
                 specs: Sequence[ConvSpec]) -> tuple[int, ...]:
    """The channel counts of a conv's segments as :func:`merge_segments`
    forms them when every group input is a tensor of its own: each input
    a segment, consecutive stripe blocks merged."""
    n_in = len(in_channels)
    out, prev = [], None
    for r in spec.reads:
        c = in_channels[r] if r < n_in else specs[r - n_in].cout
        if prev is not None and r >= n_in and r == prev + 1:
            out[-1] += c
        else:
            out.append(c)
        prev = r if r >= n_in else None
    return tuple(out)


def tma_cout_row(nt: int) -> int:
    """Couts a packed weight row holds for a cout tile of ``nt``: ``nt``,
    96 padded to 128 (the kernel loads boxes of 64)."""
    return 128 if nt == 96 else nt


def pack_tma_weights(packed: torch.Tensor, chans: Sequence[int],
                     cout: int) -> torch.Tensor:
    """:func:`pack_weights`' ``[9*Cin, cout_pad]`` -> the TMA kernel's
    rows ``[cout tile][chunk][tap][TMA_CHUNK channels]`` of the tile's
    couts (``tma_cout_row``; as ``[-1, row]``): per chunk one block of 9 x
    TMA_CHUNK rows, the kernel's weight boxes, zero past a segment's
    channels and past ``cout``. Pads and reshapes on ``packed``'s device,
    no index tensor: the training forward packs its groups every step."""
    nt, ntn = tma_cout_tile(cout)
    cpad = packed.shape[1]
    w = packed.reshape(9, sum(chans), cpad)
    # each segment's channels rounded up to whole chunks with zeros
    if any(c % TMA_CHUNK for c in chans):
        w = torch.cat([F.pad(part, (0, 0, 0, -c % TMA_CHUNK))
                       for part, c in zip(torch.split(w, list(chans), 1), chans)], 1)
    if cpad < ntn * nt:
        w = F.pad(w, (0, ntn * nt - cpad))
    w = w[:, :, :ntn * nt].reshape(9, -1, TMA_CHUNK, ntn, nt).permute(3, 1, 0, 2, 4)
    return F.pad(w, (0, tma_cout_row(nt) - nt)).reshape(-1, tma_cout_row(nt))


def _tma_lib():
    lib = _build.load("conv_group_tma")
    fn = lib.ocf_conv3x3_tma
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _tma_aligned(segs: Sequence[torch.Tensor]) -> bool:
    """TMA's address rules: 16-byte aligned bases, batch strides of whole
    16 bytes (the row and plane pitches follow from :func:`is_tma`)."""
    return all(t.data_ptr() % 16 == 0 and t.stride(0) % 8 == 0 for t in segs)


def launch_tma(segs: Sequence[torch.Tensor], packed: torch.Tensor,
               bias: torch.Tensor, out: torch.Tensor, spec: ConvSpec,
               what: str, tma: dict) -> None:
    """One conv on ``csrc/conv_group_tma.cu`` (and its split-K pass):
    ``out`` = the conv of the segments ``segs`` with the packing of
    ``packed`` for their channel counts (``tma`` caches it)."""
    chans = tuple(t.shape[1] for t in segs)
    wt = tma.get(chans)
    if wt is None:
        wt = tma[chans] = pack_tma_weights(packed, chans, spec.cout)
    codes, nchunk = _tma_plan(chans)
    ptrs, bstr, cs = segment_args(segs)
    b, _, h, w = out.shape
    nt, ntn = tma_cout_tile(spec.cout)
    split = tma_split(b, h, w, spec.cout, nchunk)
    ws = None
    if split > 1:
        ws = torch.empty(split * tma_units(b, h, w, spec.cout) * nt * TMA_TILE,
                         dtype=torch.float32, device=out.device)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    code = _tma_lib()(len(segs), ptrs, bstr, cs, b, h, w, codes, nchunk,
                      wt.data_ptr(), wt.shape[0], nt, ntn, bias.data_ptr(),
                      out.data_ptr(), out.stride(0), spec.cout, int(spec.act),
                      tma_tile_cols(w), split,
                      None if ws is None else ws.data_ptr(), stream)
    _build.check(code, what)


def launch_conv(reads: Sequence[torch.Tensor], packed: torch.Tensor,
                bias: torch.Tensor, out: torch.Tensor, spec: ConvSpec,
                what: str, counters: Sequence = (), tma: dict | None = None,
                staged: bool = False) -> None:
    """One conv launch: ``out`` (a ``[B, cout, Ho, Wo]`` channel range of
    a stripe, in the kernel dtype) = the conv of the channel concat of
    ``reads`` with ``packed`` (see :func:`pack_weights`) and the fp32
    ``bias``. On ``csrc/conv_group_tma.cu`` where :func:`is_tma` holds and
    the segments are aligned (``tma``: the conv's cache of TMA packings),
    else on ``csrc/conv_group.cu``; ``staged`` keeps a stride-1 conv on the
    staged kernel (the timing yardstick, KITTI widths). Counts the launch in
    ``conv_group.launches``, a stride-1 bf16 conv in
    ``conv_group.staged_launches``, one on the TMA kernel also in
    ``conv_group.tma_launches``, and the launch in the ``launches`` of each
    of ``counters``."""
    segs = merge_segments(reads)
    b, _, ho, wo = out.shape
    if not staged and is_tma(out.dtype, spec, (ho, wo)) and _tma_aligned(segs):
        launch_tma(segs, packed, bias, out, spec, what, {} if tma is None else tma)
        conv_group.tma_launches += 1
    else:
        ptrs, bstr, chans = segment_args(segs)
        hin, win = segs[0].shape[2:]
        stream = torch.cuda.current_stream(out.device).cuda_stream
        code = _lib()(_DTYPES[out.dtype], tile_cfg(spec.cout), len(segs), ptrs,
                      bstr, chans, b, hin, win, packed.data_ptr(),
                      bias.data_ptr(), out.data_ptr(), out.stride(0), spec.cout,
                      packed.shape[1], ho, wo, spec.stride, spec.dilation,
                      int(spec.act), *staged_tile(wo), stream)
        _build.check(code, what)
    conv_group.launches += 1
    if is_staged(out.dtype, spec):
        conv_group.staged_launches += 1
    for c in counters:
        c.launches += 1


def check_kernel_inputs(inputs: Sequence[torch.Tensor], weight: torch.Tensor,
                        what: str) -> None:
    """The kernels read channel-contiguous NCHW views on the weights'
    device."""
    for x in inputs:
        _, c, h, w = x.shape
        if x.stride()[1:] != (h * w, w, 1):
            raise ValueError(f"{what}: inputs must be channel-contiguous NCHW views")
    if weight.device != inputs[0].device:
        raise ValueError(f"{what}: weights and inputs on different devices")


def conv_group(inputs: Sequence[torch.Tensor], group: ConvGroup,
               counters: Sequence = (), staged: bool = False) -> list[torch.Tensor]:
    """Run a conv chain; returns the emitted blocks as ``[B, cout, Ho, Wo]``
    views of the group's stripe. Kernel on CUDA, plain version on the CPU.
    Each launch also counts in the ``launches`` of each of ``counters``.
    ``staged``: every stride-1 bf16 conv on the staged kernel of
    ``csrc/conv_group.cu`` instead of the TMA kernel (a yardstick)."""
    inputs = list(inputs)
    if inputs[0].device.type == "cpu":
        return conv_group_plain(inputs, group)
    if inputs[0].device.type != "cuda":
        raise ValueError(f"conv_group: unsupported device {inputs[0].device}")
    _check_inputs(inputs, group)
    check_kernel_inputs(inputs, group.packed[0], "conv_group")
    ho, wo = _out_hw(inputs, group)
    b = inputs[0].shape[0]
    stripe = torch.empty((b, group.width, ho, wo), dtype=group.dtype,
                         device=inputs[0].device)
    for j, s in enumerate(group.specs):
        o = group.offsets[j]
        launch_conv([_block(inputs, stripe, group, r) for r in s.reads],
                    group.packed[j], group.biases[j],
                    stripe[:, o:o + s.cout], s, f"conv_group conv {j}", counters,
                    group.tma[j] if group.tma else None, staged)
    return _emitted(stripe, group)


conv_group.launches = 0
conv_group.staged_launches = 0
conv_group.tma_launches = 0


class _ConvGroupDiff(torch.autograd.Function):
    """Forward: ``conv_group`` with every block emitted; backward: the port
    of ``_diff_bwd``, one conv VJP per (spec, read block)."""

    @staticmethod
    def forward(ctx, specs, n_inputs, dtype, *tensors):
        n = len(specs)
        inputs = list(tensors[:n_inputs])
        weights = tensors[n_inputs:n_inputs + n]
        biases = tensors[n_inputs + n:]
        group = prepare_group(weights, biases, specs, n_inputs, dtype,
                              inputs[0].device, [x.shape[1] for x in inputs])
        acts = conv_group(inputs, group, counters=(conv_group_diff,))
        ctx.specs, ctx.n_inputs = specs, n_inputs
        ctx.bias_dtypes = [b.dtype for b in biases]
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs, *weights, *acts)
        return tuple(acts)

    @staticmethod
    def backward(ctx, *gouts):
        specs, n_in = ctx.specs, ctx.n_inputs
        n = len(specs)
        saved = ctx.saved_tensors
        inputs, weights, acts = saved[:n_in], saved[n_in:n_in + n], saved[n_in + n:]
        need_in = ctx.needs_input_grad[3:3 + n_in]

        def block(bid):
            return inputs[bid] if bid < n_in else acts[bid - n_in]

        # cotangents accumulate in the compute dtype; bias grads reduce in
        # fp32 (the JAX adjoint's choices)
        gblk: dict[int, torch.Tensor] = {}
        dws, dbs = [None] * n, [None] * n
        for j in reversed(range(n)):
            s = specs[j]
            g, extra = gouts[j], gblk.pop(n_in + j, None)
            if g is None:
                g = extra
            elif extra is not None:
                g = g + extra.to(g.dtype)
            if g is None:  # nothing downstream reads this conv
                continue
            if s.act:
                g = g * torch.where(acts[j] >= 0, 1.0, 0.1).to(g.dtype)
            dbs[j] = g.float().sum((0, 2, 3)).to(ctx.bias_dtypes[j])
            dacc = g.to(block(s.reads[0]).dtype)
            parts, off = [], 0
            for bid in s.reads:
                x_b = block(bid)
                cb = x_b.shape[1]
                want_dx = bid >= n_in or need_in[bid]
                with full_fp32_convs(dacc.dtype):
                    dx, dw, _ = torch.ops.aten.convolution_backward(
                        dacc, x_b, weights[j][:, off:off + cb], None,
                        [s.stride] * 2, [s.dilation] * 2, [s.dilation] * 2, False,
                        [0, 0], 1, [want_dx, True, False])
                parts.append(dw)
                off += cb
                if want_dx:
                    prev = gblk.get(bid)
                    gblk[bid] = dx if prev is None else prev + dx
            dws[j] = torch.cat(parts, 1).to(weights[j].dtype)
        dins = [gblk[r].to(inputs[r].dtype) if r in gblk else None
                for r in range(n_in)]
        return (None, None, None, *dins, *dws, *dbs)


def conv_group_diff(inputs: Sequence[torch.Tensor],
                    weights: Sequence[torch.Tensor],
                    biases: Sequence[torch.Tensor],
                    specs: Sequence[ConvSpec]) -> tuple[torch.Tensor, ...]:
    """Differentiable conv chain (port of ``conv_chain_kernel.py``
    ``conv_group_diff``): returns EVERY conv's output ``[B, cout, Ho, Wo]``
    (views of one stripe), each spec's ``emit`` flag notwithstanding.

    ``weights[j]``: OIHW over spec j's reads in read order, ``biases[j]``:
    ``[cout_j]``, both graph tensors in the compute dtype (the inputs'
    dtype, fp32 or bf16): the group packs them for the kernel on every call,
    so gradients flow back through whatever produced them (a reorder, a
    cast from fp32 master weights). Forward: the conv-group kernel on CUDA
    (``conv_group_diff.launches`` counts its conv launches, which
    ``conv_group.launches`` counts as well), ``conv_group_plain`` on the
    CPU. Backward: per spec in reverse, the LeakyReLU mask from the stored
    activation, a fp32 bias-gradient sum, one conv VJP
    (``aten.convolution_backward``) per read block; the VJPs are plain
    products outside any kernel, as the JAX adjoint leaves them to XLA.
    """
    specs = tuple(dataclasses.replace(s, emit=True) for s in specs)
    inputs = list(inputs)
    dtype = inputs[0].dtype
    return _ConvGroupDiff.apply(specs, len(inputs), dtype, *inputs,
                                *weights, *biases)


conv_group_diff.launches = 0
