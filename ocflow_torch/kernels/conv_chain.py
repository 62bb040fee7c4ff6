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

``conv_group_diff`` (``conv_chain_kernel.py:conv_group_diff``) is the
differentiable form; its backward runs on the TMA kernel's adjoint
epilogue and ``csrc/conv_group_dw.cu`` (its docstring gives the routes).
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
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _tma_aligned(segs: Sequence[torch.Tensor]) -> bool:
    """TMA's address rules: 16-byte aligned bases, batch strides of whole
    16 bytes (the row and plane pitches follow from :func:`is_tma`)."""
    return all(t.data_ptr() % 16 == 0 and t.stride(0) % 8 == 0 for t in segs)


def launch_tma(segs: Sequence[torch.Tensor], packed: torch.Tensor,
               bias: torch.Tensor | None, out: torch.Tensor, spec: ConvSpec,
               what: str, tma: dict, gout: torch.Tensor | None = None,
               act: torch.Tensor | None = None) -> None:
    """One conv on ``csrc/conv_group_tma.cu`` (and its split-K pass):
    ``out`` = the conv of the segments ``segs`` with the packing of
    ``packed`` for their channel counts (``tma`` caches it). ``bias`` None
    takes the adjoint epilogue of B3's backward: ``out`` = the conv (+
    ``gout``), times 0.1 where ``act`` is negative (either None: left
    out; both ``[B, cout, H, W]`` channel-contiguous views)."""
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
                      wt.data_ptr(), wt.shape[0], nt, ntn,
                      None if bias is None else bias.data_ptr(),
                      out.data_ptr(), out.stride(0), spec.cout, int(spec.act),
                      tma_tile_cols(w), split,
                      None if ws is None else ws.data_ptr(),
                      None if gout is None else gout.data_ptr(),
                      0 if gout is None else gout.stride(0),
                      None if act is None else act.data_ptr(),
                      0 if act is None else act.stride(0), stream)
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


# -- B3: conv_group_diff and its backward ------------------------------------
#
# The adjoint of a DenseNet conv chain is a conv chain run in reverse. Conv
# j's masked cotangent g~_j = (gout_j + sum over the convs k reading block
# n_in + j of convT(g~_k, W_k[that block])) x LeakyReLU'(act_j) is kept in a
# gradient stripe laid out as the forward's; at stride 1 convT(g, W) is the
# conv of g with W flipped in space and its in and out channels swapped,
# so a block's cotangent is one conv over the gradient-stripe segment of its
# readers (csrc/conv_group_tma.cu's adjoint epilogue), and dW_j, db_j are
# sums over pixels of g~_j against the windows of conv j's reads
# (csrc/conv_group_dw.cu).

# The dW kernel (these match csrc/conv_group_dw.cu): K steps of DW_PIX
# pixels of one row, read channels in chunks of DW_CHUNK (one wgmma M, a
# segment's last chunk zero-filled past its end), couts in tiles of 2 nw,
# nw one of DW_NW couts per consumer warpgroup.
DW_PIX = 64
DW_CHUNK = 64
DW_MAX_CHUNKS = 64
DW_NW = (8, 16, 32)


def dw_cout_tile(cout: int) -> tuple[int, int]:
    """``(nw, tiles)``: couts per consumer warpgroup, the smallest of
    ``DW_NW`` whose two warpgroups hold ``cout`` (else 32), and the tiles
    of ``2 nw`` couts."""
    nw = next((n for n in DW_NW if cout <= 2 * n), DW_NW[-1])
    return nw, -(-cout // (2 * nw))


def dw_chunks(chans: Sequence[int]) -> list[tuple[int, int]]:
    """The dW kernel's M chunks over read segments of ``chans`` channels,
    in order: ``(segment, first channel)``, ``DW_CHUNK`` channels each."""
    out = [(s, c0) for s, c in enumerate(chans) for c0 in range(0, c, DW_CHUNK)]
    if len(out) > DW_MAX_CHUNKS:
        raise ValueError(f"{len(out)} dW chunks > {DW_MAX_CHUNKS}")
    return out


@functools.lru_cache(maxsize=None)
def _dw_plan(chans: tuple[int, ...]):
    chunks = dw_chunks(chans)
    return (ctypes.c_int * len(chunks))(*[seg | c0 << 3 for seg, c0 in chunks]), len(chunks)


@functools.lru_cache(maxsize=None)
def dw_split(b: int, h: int, w: int, nchunk: int, ntn: int) -> int:
    """Blocks that share one (chunk, cout tile)'s K, the ``b h
    ceil(w / DW_PIX)`` row steps: as many as fill one wave of the H100's
    SMs with the ``nchunk x ntn`` units (1 where they fill it alone), at
    most one a K step."""
    ksteps = b * h * -(-w // DW_PIX)
    return max(1, min(ksteps, H100_SMS // (nchunk * ntn)))


def _dw_lib():
    lib = _build.load("conv_group_dw")
    fn = lib.ocf_conv3x3_dw
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _nchw(t: torch.Tensor) -> bool:
    """A channel-contiguous ``[B, C, H, W]`` view (any batch stride)."""
    _, _, h, w = t.shape
    return t.stride()[1:] == (h * w, w, 1)


def adjoint_plain(parts, gout: torch.Tensor | None, act: torch.Tensor | None,
                  dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the adjoint conv (``csrc/conv_group_tma.cu``'s
    adjoint epilogue): for each part ``(segs, packed, dilation)`` the conv
    of the channel concat of ``segs`` with the adjoint weights ``packed``
    (:func:`adjoint_packed`), fp32 and summed in fp32; plus ``gout``; times
    0.1 where ``act`` is negative; one rounding to ``dtype``."""
    acc = None
    for segs, packed, d in parts:
        x = torch.cat([t.float() for t in segs], 1)
        w = packed.float().view(3, 3, x.shape[1], -1).permute(3, 2, 0, 1)
        with full_fp32_convs(torch.float32):
            y = F.conv2d(x, w, padding=d, dilation=d)
        acc = y if acc is None else acc + y
    if gout is not None:
        acc = acc + gout.float()
    if act is not None:
        acc = torch.where(act >= 0, acc, acc * 0.1)
    return acc.to(dtype)


def conv_adjoint(parts, gout: torch.Tensor | None, act: torch.Tensor | None,
                 out: torch.Tensor, tma: dict | None = None,
                 what: str = "conv_group_diff dX") -> torch.Tensor:
    """``out`` (a ``[B, C, H, W]`` channel-contiguous view) = the adjoint
    conv of :func:`adjoint_plain`. On CUDA the kernel: one part of
    dilation 1 on ``csrc/conv_group_tma.cu`` (its adjoint epilogue, the
    TMA packing cached in ``tma``), counted in
    ``conv_group_diff.dx_launches``; anything else raises. On the CPU the
    plain version."""
    if out.device.type == "cpu":
        return out.copy_(adjoint_plain(parts, gout, act, out.dtype))
    if len(parts) != 1 or parts[0][2] != 1:
        raise ValueError(f"{what}: the kernel takes one part of dilation 1")
    segs, packed, _ = parts[0]
    segs = merge_segments(segs)
    b, c, h, w = out.shape
    spec = ConvSpec((), c, act=False)
    if gout is not None:
        gout = gout.contiguous()
    views = [out, *(t for t in (gout, act) if t is not None)]
    if (not is_tma(out.dtype, spec, (h, w)) or not _tma_aligned(segs)
            or any(t.dtype != out.dtype or t.shape != out.shape or not _nchw(t)
                   for t in views) or any(t.dtype != out.dtype or not _nchw(t) for t in segs)):
        raise ValueError(f"{what}: the TMA kernel does not take {tuple(out.shape)} "
                         f"{out.dtype}")
    launch_tma(segs, packed, None, out, spec, what, {} if tma is None else tma, gout, act)
    conv_group_diff.dx_launches += 1
    return out


def dw_plain(reads: Sequence[torch.Tensor], g: torch.Tensor, w_dtype: torch.dtype,
             b_dtype: torch.dtype, dilation: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``csrc/conv_group_dw.cu``: ``(dW [cout, Cin, 3, 3]
    in w_dtype, db [cout] in b_dtype)`` of a 3x3 conv of stride 1 over the
    channel concat of ``reads`` whose output cotangent is ``g``: per tap a
    contraction over the pixels of g with the reads' window, and the sum
    of g, in fp32."""
    x = torch.cat([t.float() for t in reads], 1)
    h, w = g.shape[2:]
    d = dilation
    xp = F.pad(x, (d, d, d, d))
    g32 = g.float()
    with full_fp32_convs(torch.float32):
        taps = [torch.einsum("bohw,bihw->oi", g32, xp[:, :, ky * d:ky * d + h, kx * d:kx * d + w])
                for ky in range(3) for kx in range(3)]
    dw = torch.stack(taps, -1).view(g.shape[1], x.shape[1], 3, 3)
    return dw.to(w_dtype), g32.sum((0, 2, 3)).to(b_dtype)


def conv_dw(reads: Sequence[torch.Tensor], g: torch.Tensor, w_dtype: torch.dtype,
            b_dtype: torch.dtype, dilation: int = 1,
            what: str = "conv_group_diff dW") -> tuple[torch.Tensor, torch.Tensor]:
    """dW and db of :func:`dw_plain`. On CUDA ``csrc/conv_group_dw.cu``
    (bf16, dilation 1, 16-byte rows, channel-contiguous reads and ``g``;
    anything else raises), counted in ``conv_group_diff.dw_launches``; its
    fp32 partial sums go to a workspace and a second pass sums them in a
    fixed order. On the CPU the plain version."""
    if g.device.type == "cpu":
        return dw_plain(reads, g, w_dtype, b_dtype, dilation)
    segs = merge_segments(reads)
    b, cout, h, w = g.shape
    bf16 = torch.bfloat16
    if (dilation != 1 or w % 8 or {w_dtype, b_dtype, g.dtype} != {bf16}
            or any(t.dtype != bf16 or not _nchw(t) or t.shape[2:] != g.shape[2:]
                   for t in (*segs, g)) or not _tma_aligned([*segs, g])):
        raise ValueError(f"{what}: the dW kernel does not take {tuple(g.shape)} "
                         f"{g.dtype} (dilation {dilation})")
    chans = tuple(t.shape[1] for t in segs)
    codes, nchunk = _dw_plan(chans)
    nw, ntn = dw_cout_tile(cout)
    split = dw_split(b, h, w, nchunk, ntn)
    dev = g.device
    n_ws = nchunk * ntn * split * 2 * nw * DW_CHUNK * 9
    ws = torch.empty(n_ws + ntn * split * 2 * nw, dtype=torch.float32, device=dev)
    ws_db = ws[n_ws:]
    dw = torch.empty((cout, sum(chans), 3, 3), dtype=bf16, device=dev)
    db = torch.empty(cout, dtype=bf16, device=dev)
    ptrs, bstr, cs = segment_args(segs)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = _dw_lib()(len(segs), ptrs, bstr, cs, b, h, w, codes, nchunk, g.data_ptr(),
                     g.stride(0), cout, nw, split, ws.data_ptr(), ws_db.data_ptr(),
                     dw.data_ptr(), db.data_ptr(), stream)
    _build.check(code, what)
    conv_group_diff.dw_launches += 1
    return dw, db


def block_readers(specs: Sequence[ConvSpec], chans: Sequence[int],
                  bid: int) -> list[tuple[int, int]]:
    """``(conv k, channel offset)`` of each read of block ``bid``, in conv
    order: the block's channels start at that offset of conv k's weight
    input channels (``chans``: every block's channel count)."""
    out = []
    for k, s in enumerate(specs):
        off = 0
        for r in s.reads:
            if r == bid:
                out.append((k, off))
            off += chans[r]
    return out


def adjoint_packed(packed: Sequence[torch.Tensor], specs: Sequence[ConvSpec], cb: int,
                   readers: Sequence[tuple[int, int]]) -> torch.Tensor:
    """The adjoint weights of a block of ``cb`` channels read by
    ``readers`` (:func:`block_readers`), in :func:`pack_weights`' layout
    over the readers' cotangents: ``[9 * sum(cout_k), cb]``, row ``tap *
    Cin + c``; the block's rows of each reader's forward packing
    (``packed[k]``: ``[9 * Cin_k, cout_pad]``), its couts as input
    channels, the taps reversed (the 3x3 window flipped in both axes).
    One cat and one flip on the packing's device."""
    pieces = []
    for k, off in readers:
        p = packed[k]
        p = p.view(9, p.shape[0] // 9, p.shape[1])
        pieces.append(p[:, off:off + cb, :specs[k].cout].transpose(1, 2))
    return torch.cat(pieces, 1).flip(0).reshape(-1, cb)


def reader_chans(specs: Sequence[ConvSpec], ks: Sequence[int]) -> tuple[int, ...]:
    """The channel counts of the gradient-stripe segments of readers
    ``ks`` as :func:`merge_segments` forms them: consecutive convs' blocks
    merged."""
    out, prev = [], None
    for k in ks:
        if prev is not None and k == prev + 1:
            out[-1] += specs[k].cout
        else:
            out.append(specs[k].cout)
        prev = k
    return tuple(out)


def input_runs(specs: Sequence[ConvSpec], chans: Sequence[int],
               need: Sequence[bool]) -> list[tuple[int, ...]]:
    """The group inputs whose cotangents are convs (some conv reads them,
    they ``need`` a gradient), in runs of consecutive inputs that every
    conv reading one of them reads all of, together and in order: one
    adjoint conv a run, over the same readers (the main path's four
    decoder inputs are one run)."""
    runs: list[tuple[int, ...]] = []
    for r, want in enumerate(need):
        if not want or not block_readers(specs, chans, r):
            continue
        run = (*runs[-1], r) if runs and runs[-1][-1] == r - 1 else None
        if run is not None and all(
                not any(b in run for b in s.reads)
                or (sum(b in run for b in s.reads) == len(run)
                    and s.reads[s.reads.index(run[0]):][:len(run)] == run)
                for s in specs):
            runs[-1] = run
        else:
            runs.append((r,))
    return runs


@functools.lru_cache(maxsize=64)
def _adjoint_layout(specs: tuple[ConvSpec, ...], chans: tuple[int, ...],
                    need: tuple[bool, ...], kernel: bool, device: torch.device):
    """Where :func:`adjoint_plan`'s tensors come from, for one group
    geometry: ``(layout, index)``. ``index`` (int64, on ``device``) holds,
    for every element of every plan tensor laid end to end, 1 + its
    position in the group's OIHW weights flattened and concatenated (0: a
    zero of the padding); ``layout`` maps each plan key to its parts
    ``(convs, dilation, (start, end, shape), tma)``, ``tma`` ``(segments,
    start, end, shape)`` or None. Built by the packing functions
    themselves run on the weights' positions, once per geometry."""
    n_in = len(chans) - len(specs)
    pos_packed, base = [], 1
    for s in specs:
        cin = sum(chans[r] for r in s.reads)
        pos = torch.arange(base, base + s.cout * cin * 9, device=device)
        pos_packed.append(pack_weights(pos.view(s.cout, cin, 3, 3), torch.int64))
        base += s.cout * cin * 9
    pieces, layout, at = [], {}, 0

    def put(t):
        nonlocal at
        pieces.append(t.reshape(-1))
        at += t.numel()
        return at - t.numel(), at, tuple(t.shape)

    stripe = [(bid, (bid,)) for bid in range(n_in, len(chans))]
    for key, ids in stripe + [(run, run) for run in input_runs(specs, chans, need[:n_in])]:
        readers = block_readers(specs, chans, ids[0])
        if not readers:
            continue
        cb = sum(chans[b] for b in ids)
        parts = []
        for d in dict.fromkeys(specs[k].dilation for k, _ in readers):
            rs = [(k, off) for k, off in readers if specs[k].dilation == d]
            ks = [k for k, _ in rs]
            packed = adjoint_packed(pos_packed, specs, cb, rs)
            tma = None
            if kernel:
                seg = reader_chans(specs, ks)
                tma = (seg, *put(pack_tma_weights(packed, seg, cb)))
            parts.append((ks, d, put(packed), tma))
        layout[key] = parts
    return layout, torch.cat(pieces)


def adjoint_plan(group: ConvGroup, chans: Sequence[int], need: Sequence[bool],
                 kernel: bool) -> dict:
    """Per block whose cotangent is a conv (a stripe block that some conv
    reads, by its id; a run of :func:`input_runs`, by the tuple of its
    ids): per dilation of its readers ``(convs, dilation, adjoint_packed,
    tma)``, ``tma`` the TMA kernel's packing of it for the readers'
    segments (``kernel``) or empty. Packed once per forward call, for the
    backward: one cat of the weights and one gather through the index of
    :func:`_adjoint_layout` (built once per group geometry), every tensor
    a view of the gathered one."""
    ws = group.weights
    layout, index = _adjoint_layout(group.specs, tuple(chans), tuple(need), kernel,
                                    ws[0].device)
    vals = torch.cat([ws[0].new_zeros(1), *(w.reshape(-1) for w in ws)])[index]
    view = lambda a, b, shape: vals[a:b].view(shape)  # noqa: E731
    return {key: [(ks, d, view(*packed), {} if tma is None else {tma[0]: view(*tma[1:])})
                  for ks, d, packed, tma in parts]
            for key, parts in layout.items()}


def backward_route(inputs: Sequence[torch.Tensor], specs: Sequence[ConvSpec],
                   dtype: torch.dtype) -> str:
    """``"kernel"``, ``"plain"`` or ``"vjp"``: how ``conv_group_diff``'s
    backward runs a group (its docstring)."""
    if any(s.stride != 1 for s in specs):
        return "vjp"
    if inputs[0].device.type == "cpu":
        return "plain"
    hw = tuple(inputs[0].shape[2:])
    if all(is_tma(dtype, s, hw) for s in specs) and _tma_aligned(inputs):
        return "kernel"
    return "vjp"


def chain_backward(plan: dict, specs: Sequence[ConvSpec], offsets: Sequence[int],
                   width: int, inputs, weights, acts, gouts, bias_dtypes):
    """``(dinputs, dweights, dbiases)`` of a conv group from its adjoint
    ``plan`` (:func:`adjoint_plan`): per conv newest first, its masked
    cotangent into the gradient stripe (:func:`conv_adjoint` where convs
    read its block; else ``gout`` times LeakyReLU' as a plain torch op, or
    zeros where no cotangent reaches it), then its dW and db
    (:func:`conv_dw`; none where no cotangent reaches it); then the inputs'
    cotangents, one :func:`conv_adjoint` a run of the plan, each input's a
    channel range of its run's."""
    n_in, n = len(inputs), len(specs)
    b = inputs[0].shape[0]
    h, w = acts[0].shape[2:]
    gs = torch.empty((b, width, h, w), dtype=acts[0].dtype, device=acts[0].device)
    gv = [gs[:, o:o + s.cout] for o, s in zip(offsets, specs)]
    # conv reads for dW: the group inputs as one segment where a conv reads
    # them all first, in order (fewer zero-padded channel chunks)
    xin = torch.cat(list(inputs), 1) if n_in > 1 else inputs[0]

    def segments(ids, view, stripe):
        """The views of blocks ``ids``, each run of consecutive stripe
        blocks (adjacent channel ranges) as one view."""
        out, prev = [], None
        for i in ids:
            v = view(i)
            if prev is not None and stripe(i) and i == prev + 1:
                p = out[-1]
                out[-1] = p.as_strided((p.shape[0], p.shape[1] + v.shape[1], *p.shape[2:]),
                                       p.stride())
            else:
                out.append(v)
            prev = i if stripe(i) else None
        return out

    def reads(s):
        prefix = s.reads[:n_in] == tuple(range(n_in))
        return [xin] * prefix + segments(
            s.reads[n_in * prefix:], lambda r: inputs[r] if r < n_in else acts[r - n_in],
            lambda r: r >= n_in)

    def adjoint(parts, gout, act, out):
        return conv_adjoint([(segments(ks, gv.__getitem__, lambda k: True), packed, d)
                             for ks, d, packed, _ in parts],
                            gout, act, out, parts[0][3] if len(parts) == 1 else None)

    dws, dbs = [None] * n, [None] * n
    for j in reversed(range(n)):
        s, g = specs[j], gouts[j]
        act = acts[j] if s.act else None
        if n_in + j in plan:
            adjoint(plan[n_in + j], g, act, gv[j])
        elif g is None:  # nothing reaches this conv's output
            gv[j].zero_()
            continue
        else:
            gv[j].copy_(g if act is None else torch.where(act >= 0, g, g * 0.1))
        dws[j], dbs[j] = conv_dw(reads(s), gv[j], weights[j].dtype, bias_dtypes[j],
                                 s.dilation)
    dins = [None] * n_in
    for run in (k for k in plan if isinstance(k, tuple)):
        out = torch.empty((b, sum(inputs[r].shape[1] for r in run), h, w),
                          dtype=inputs[run[0]].dtype, device=gs.device)
        adjoint(plan[run], None, None, out)
        off = 0
        for r in run:
            dins[r] = out[:, off:off + inputs[r].shape[1]]
            off += inputs[r].shape[1]
    return dins, dws, dbs


def vjp_backward(specs: Sequence[ConvSpec], inputs, weights, acts, gouts, need_in,
                 bias_dtypes):
    """B3's backward as the JAX adjoint (``_diff_bwd``) runs it: per conv in
    reverse, the LeakyReLU mask from the stored activation, an fp32 bias
    gradient, one conv VJP (cuDNN's ``aten.convolution_backward``) per read
    block, the cotangents summed in the compute dtype.
    ``conv_group_diff.vjp_calls`` counts the VJPs."""
    n_in, n = len(inputs), len(specs)

    def block(bid):
        return inputs[bid] if bid < n_in else acts[bid - n_in]

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
        dbs[j] = g.float().sum((0, 2, 3)).to(bias_dtypes[j])
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
            conv_group_diff.vjp_calls += 1
            parts.append(dw)
            off += cb
            if want_dx:
                prev = gblk.get(bid)
                gblk[bid] = dx if prev is None else prev + dx
        dws[j] = torch.cat(parts, 1).to(weights[j].dtype)
    dins = [gblk[r].to(inputs[r].dtype) if r in gblk else None for r in range(n_in)]
    return dins, dws, dbs


class _ConvGroupDiff(torch.autograd.Function):
    """Forward: ``conv_group`` with every block emitted, and (where a
    gradient is wanted and the backward is not the VJP route) the adjoint
    weights packed for the backward; backward: :func:`chain_backward` or
    :func:`vjp_backward` (``conv_group_diff``'s docstring)."""

    @staticmethod
    def forward(ctx, specs, n_inputs, dtype, vjp, *tensors):
        n = len(specs)
        inputs = list(tensors[:n_inputs])
        weights = tensors[n_inputs:n_inputs + n]
        biases = tensors[n_inputs + n:]
        group = prepare_group(weights, biases, specs, n_inputs, dtype,
                              inputs[0].device, [x.shape[1] for x in inputs])
        acts = conv_group(inputs, group, counters=(conv_group_diff,))
        ctx.route = "vjp" if vjp else backward_route(inputs, specs, dtype)
        ctx.plan = None
        if ctx.route != "vjp" and any(ctx.needs_input_grad[4:]):
            chans = [x.shape[1] for x in inputs] + [s.cout for s in specs]
            ctx.plan = adjoint_plan(group, chans, ctx.needs_input_grad[4:4 + n_inputs],
                                    ctx.route == "kernel")
        ctx.specs, ctx.n_inputs = specs, n_inputs
        ctx.offsets, ctx.width = group.offsets, group.width
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
        if ctx.route == "vjp":
            grads = vjp_backward(specs, inputs, weights, acts, gouts,
                                 ctx.needs_input_grad[4:4 + n_in], ctx.bias_dtypes)
        else:
            grads = chain_backward(ctx.plan, specs, ctx.offsets, ctx.width, inputs,
                                   weights, acts, gouts, ctx.bias_dtypes)
        dins, dws, dbs = grads
        return (None, None, None, None, *dins, *dws, *dbs)


def conv_group_diff(inputs: Sequence[torch.Tensor],
                    weights: Sequence[torch.Tensor],
                    biases: Sequence[torch.Tensor],
                    specs: Sequence[ConvSpec], vjp: bool = False) -> tuple[torch.Tensor, ...]:
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
    CPU.

    Backward, one of three routes, chosen by the forward from the group:

    - on CUDA, a group whose every conv the TMA kernel takes (bf16, stride
      1, dilation 1, rows of 16-byte multiples: :func:`is_tma`) and whose
      inputs are TMA-aligned runs :func:`chain_backward` on two hand
      kernels: each block's cotangent on ``csrc/conv_group_tma.cu``'s
      adjoint epilogue (``conv_group_diff.dx_launches``), each conv's dW
      and db on ``csrc/conv_group_dw.cu`` (``conv_group_diff.dw_launches``),
      fp32 sums with one rounding each; the adjoint weights are packed
      once by the forward (:func:`adjoint_plan`). All 31 convs of the
      448x1024 bf16 step run it. A block no conv reads (the head's, level
      2's context conv's) takes ``gout`` times LeakyReLU' as a plain torch
      op.
    - on the CPU, every group of stride-1 convs runs the same
      :func:`chain_backward` on the two kernels' plain versions (the
      adjoint as ``F.conv2d`` with the flipped, transposed weights per
      reader dilation, fp32 sums; dW as per-tap contractions over pixels).
    - every other group keeps the VJP route, :func:`vjp_backward` (one
      cuDNN conv VJP per read block, ``conv_group_diff.vjp_calls``), as the
      reference leaves its backward to XLA: fp32 and dilated groups on
      CUDA, KITTI's widths 76, 38 and 19, stride-2 specs anywhere. ``vjp``
      forces it (the yardstick).
    """
    specs = tuple(dataclasses.replace(s, emit=True) for s in specs)
    inputs = list(inputs)
    dtype = inputs[0].dtype
    return _ConvGroupDiff.apply(specs, len(inputs), dtype, vjp, *inputs,
                                *weights, *biases)


conv_group_diff.launches = 0
conv_group_diff.dx_launches = 0
conv_group_diff.dw_launches = 0
conv_group_diff.vjp_calls = 0
