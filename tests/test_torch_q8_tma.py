"""The int8 TMA conv kernel's decomposition, emulated on the CPU.

``csrc/conv_group_q8_tma.cu`` (every int8-read conv of a group whose int8
convs are all of stride 1 and dilation 1) cannot run here, so this file runs
its loop in PyTorch, unit by unit, with the kernel's own layout and order:
the channels-innermost int8 stripe (``stripe_layout_q8``: the inputs packed
from channel 0, each q8 block on a multiple of 32 channels), filled with
random codes wherever no block lies, so that a channel the conv does not
read shows unless its weight rows are zero; per 32-channel chunk
(``tma_chunks_q8``; one ring stage) the TMA box of the tile's window, rows
y0 - 1 .. y0 + R and columns x0 - 1 .. x0 + C, zero filled outside the
image, as a flat run of pixels followed by a slack of random codes; per tap
(dy, dx) and m64 block m (``tma_q8_tile``) the 64 pixels from m mstride + dy
BW + dx against the packed rows of the tap (``pack_tma_weights_q8``);
s32 partial sums per K split over the chunk ranges the kernel gives each
block, summed in s32; the epilogue masked past the tile, H, W and cout.
Held against ``conv_group_q8_plain`` bit for bit (``torch.equal``), and one
decoder group against the JAX ``conv_group_q8`` in interpret mode within
tests/test_torch_q8.py's tolerances. The kernel itself is held against the
plain version on the card in tests/test_torch_gpu.py.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ocflow_torch.kernels import _build
from ocflow_torch.kernels.conv_chain import ConvSpec, out_hw
from ocflow_torch.kernels.conv_chain_q8 import (QMAX, TMA_Q8_CHUNK, TMA_Q8_COUT_TILES,
                                                TMA_Q8_KHALF, TMA_Q8_MAX_CHUNKS,
                                                TMA_Q8_SLACK, TMA_Q8_STAGE_MAX, TMA_Q8_TILE,
                                                _block, _emitted, _read_ranges,
                                                conv_group_q8, conv_group_q8_plain,
                                                pack_tma_weights_q8, prepare_group_q8,
                                                quantize_q8, stripe_layout_q8, stripes_q8,
                                                tma_chunks_q8,
                                                tma_q8_cout_tile, tma_q8_split, tma_q8_tile)
from ocflow_torch.models import FlowNetCV, pwc_fast
from ocflow_tpu.ops.pallas import conv_chain_kernel as jcc
from test_torch_gpu import decoder_like_q8_case, flownet_decoder_q8_case, mixed_q8_case
from test_torch_q8 import _bf16_close, _oihw, _unflat
from test_torch_ops import share_cores  # noqa: F401  (autouse)

def _epilogue(acc, dq, bq, act, q8):
    """The plain version's epilogue on s32 sums ``[..., cout]``."""
    v = acc.float() * dq
    v = v + bq
    if act:
        v = torch.where(v >= 0, v, v * 0.1)
    return torch.round(v).clamp_(-QMAX, QMAX).to(torch.int8) if q8 else v.to(torch.bfloat16)


def _box(s8, b, c0, y0, nh, x0, nw):
    """``s8[b, c0:c0+32, y0:y0+nh, x0:x0+nw]`` of the channels-last stripe
    as ``[nh, nw, 32]`` with zeros outside the image: a chunk's two TMA
    boxes."""
    _, c, h, w = s8.shape
    box = torch.zeros(nh, nw, TMA_Q8_CHUNK, dtype=torch.int64)
    ys, ye, xs, xe = max(y0, 0), min(y0 + nh, h), max(x0, 0), min(x0 + nw, w)
    if ys < ye and xs < xe:
        box[ys - y0:ye - y0, xs - x0:xe - x0] = \
            s8[b, c0:c0 + TMA_Q8_CHUNK, ys:ye, xs:xe].permute(1, 2, 0).long()
    return box


def _tma_conv_q8(s8, group, j, out, split=None, seed=0):
    """One launch of the TMA kernel (and its split-K pass), emulated:
    writes ``out`` and returns how often each output pixel was written."""
    s = group.specs[j]
    packed, _, nchunk = group.tma8[j]
    b, cout, h, w = out.shape
    assert tuple(s8.shape[2:]) == (h, w) and s8.shape[1] == group.width8
    ranges = _read_ranges(s, group.in_offsets, group.offsets, group.in_channels, group.specs)
    chunks = tma_chunks_q8(ranges)
    assert len(chunks) == nchunk
    nt, ntn = tma_q8_cout_tile(cout)
    r, c, mstride, mt = tma_q8_tile(h, w)
    bw = c + 2
    if split is None:
        split = tma_q8_split(b, h, w, cout, nchunk)
    assert 1 <= split <= nchunk
    # [cout tile][chunk][tap][nt][32 channels]
    wt = packed.view(ntn, nchunk, 9, 2, nt, TMA_Q8_KHALF).permute(0, 1, 2, 4, 3, 5)
    # float64 holds every product and sum here exactly (BLAS, not integer loops)
    wt = wt.reshape(ntn, nchunk, 9, nt, TMA_Q8_CHUNK).double()
    gen = torch.Generator().manual_seed(seed)
    slack = TMA_Q8_SLACK
    # window pixels each tap of each m64 block reads: [9, mt, 64]
    taps = torch.tensor([dy * bw + dx for dy in range(3) for dx in range(3)])
    rows = taps[:, None, None] + torch.arange(mt)[None, :, None] * mstride \
        + torch.arange(64)[None, None, :]
    assert int(rows.max()) < (r + 2) * bw + slack
    e = torch.arange(mt)[:, None] * mstride + torch.arange(64)[None, :]
    er, ec = e // bw, e % bw
    hits = torch.zeros(h, w, dtype=torch.int64)
    for bi in range(b):
        for y0 in range(0, h, r):
            for x0 in range(0, w, c):
                ok = (ec < c) & (er < r) & (y0 + er < h) & (x0 + ec < w)
                ys, xs = (y0 + er)[ok], (x0 + ec)[ok]
                for n in range(ntn):
                    total = torch.zeros(mt, 64, nt, dtype=torch.int32)
                    for sp in range(split):
                        acc = torch.zeros(mt, 64, nt, dtype=torch.float64)
                        for st in range(sp * nchunk // split, (sp + 1) * nchunk // split):
                            win = _box(s8, bi, chunks[st], y0 - 1, r + 2, x0 - 1, bw)
                            flat = torch.cat([win.reshape(-1, TMA_Q8_CHUNK), torch.randint(
                                -128, 128, (slack, TMA_Q8_CHUNK), generator=gen)])
                            acc += torch.einsum("tmpk,tnk->mpn", flat[rows].double(),
                                                wt[n, st])
                        assert int(acc.abs().max()) < 2 ** 31
                        total += acc.to(torch.int32)  # the split-K pass: s32
                    co = slice(n * nt, min((n + 1) * nt, cout))
                    v = _epilogue(total[ok][:, :co.stop - co.start], group.dq[j][co],
                                  group.bq[j][co], s.act, s.q8)
                    out[bi, co, ys, xs] = v.t()
                    if n == 0 and bi == 0:
                        hits[ys, xs] += 1
    return hits


def _tma_group_q8(inputs, group, split=None):
    """``conv_group_q8`` of a channels-innermost group on the emulated
    kernel (the bf16-read convs as the plain version computes them): the
    int8 stripe starts as random codes, the bf16 stripe as NaN."""
    assert group.nhwc
    ho, wo = out_hw([tuple(x.shape[2:]) for x in inputs], group.specs)
    b = inputs[0].shape[0]
    gen = torch.Generator().manual_seed(1)
    s8 = torch.randint(-128, 128, (b, ho, wo, group.width8), generator=gen,
                       dtype=torch.int8).permute(0, 3, 1, 2)
    s16 = torch.full((b, group.width16, ho, wo), float("nan"), dtype=torch.bfloat16)
    views = [s8[:, o:o + c] for o, c in zip(group.in_offsets, group.in_channels)]
    for v, x in zip(views, inputs):
        v.copy_(x)
    for j, s in enumerate(group.specs):
        out = _block(views, s8, s16, group, group.n_inputs + j)
        if group.int8_read[j]:
            sp = None if split is None else min(split, group.tma8[j][2])
            hits = _tma_conv_q8(s8, group, j, out, sp, seed=j)
            assert bool((hits == 1).all()), f"conv {j}: pixels written {hits.unique()}"
        else:
            x = torch.cat([_block(views, s8, s16, group, r) for r in s.reads], 1)
            v = F.conv2d(x.float(), group.weights[j].float(), group.bq[j], padding=1)
            out.copy_((F.leaky_relu(v, 0.1) if s.act else v).to(torch.bfloat16))
    return _emitted(s8, s16, group)


CASES = {
    # reads out of order, q8 and bf16 outputs, a bf16-read conv (flat tiles)
    "mixed 9x70": mixed_q8_case,
    # couts 128, 96, 2, 8; 8 int8 segments out of order
    "decoder-like 7x16": lambda rng: decoder_like_q8_case(rng, 7, 16),
    "decoder-like 5x64": lambda rng: decoder_like_q8_case(rng, 5, 64),
    "decoder-like 3x136": lambda rng: decoder_like_q8_case(rng, 3, 136),
    # FlowNetCV's decoders at their widths (rows, flat, ragged tiles)
    "flownet L2 2x256": lambda rng: flownet_decoder_q8_case(rng, 2, 256, level2=True),
    "flownet 5x128": lambda rng: flownet_decoder_q8_case(rng, 5, 128),
    "flownet 3x64": lambda rng: flownet_decoder_q8_case(rng, 3, 64),
    "flownet 9x32": lambda rng: flownet_decoder_q8_case(rng, 9, 32),
    "flownet 7x16": lambda rng: flownet_decoder_q8_case(rng, 7, 16),
    # KITTI 320x1216's narrow levels: 19 and 76 wide
    "flownet 5x19": lambda rng: flownet_decoder_q8_case(rng, 5, 19),
    "flownet 4x76": lambda rng: flownet_decoder_q8_case(rng, 4, 76),
}


def _prepared(case, seed=7):
    rng = np.random.default_rng(seed)
    inputs, weights, biases, specs, s_in, scales = case(rng)
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    group = prepare_group_q8([t(w) for w in weights], [t(b) for b in biases], specs,
                             [x.shape[1] for x in inputs], s_in, scales, "cpu")
    return [quantize_q8(t(x), s_in) for x in inputs], group


def _equal(got, ref):
    for g, r in zip(got, ref, strict=True):
        assert g.dtype == r.dtype and torch.equal(g, r), (
            (g.float() - r.float()).abs().max().item())


@pytest.mark.parametrize("name", list(CASES))
def test_tma_q8_decomposition_matches_plain(name):
    xs, group = _prepared(CASES[name])
    assert group.nhwc and group.n_tma8 == group.n_int8 > 0
    _equal(_tma_group_q8(xs, group), conv_group_q8_plain(xs, group))


def _forward_splits(size):
    """Every split factor ``tma_q8_split`` picks for the int8 convs of the
    W8A8 forward at ``size``."""
    model = FlowNetCV(generator=torch.Generator().manual_seed(0))
    scales = {f"dec{i}": {"in": 0.1, "growth": [0.1] * 5} for i in range(5)}
    fw = pwc_fast.prepare(model, torch.float32, "cpu", scales)
    splits = set()
    for g, (b, h, w) in zip(fw.groups(), fw.group_shapes(size)):
        if getattr(g, "nhwc", False):
            for j, s in enumerate(g.specs):
                if g.int8_read[j]:
                    splits.add(tma_q8_split(b, h, w, s.cout, g.tma8[j][2]))
    return sorted(splits)


def test_forward_split_factors_match_plain():
    """Every split-K factor the router picks at 8x448x1024, forced on one
    decoder group: the s32 partial sums of each split, summed, equal the
    plain conv bit for bit."""
    splits = _forward_splits((8, 448, 1024))
    assert splits[0] == 1 and max(splits) > 2, splits
    xs, group = _prepared(CASES["flownet 7x16"], seed=3)
    ref = conv_group_q8_plain(xs, group)
    for sp in splits:
        _equal(_tma_group_q8(xs, group, split=sp), ref)


def test_views_equal_the_nchw_blocks():
    """The channels-innermost group's ``[B, C, H, W]`` views hold what the
    NCHW layout of the same group holds (the plain version on both), the
    q8 blocks channels-innermost; inputs quantized into their places are
    ``stripes_q8`` writes into their places, quantizing values (the
    concat's one quantize equal to each input's) or copying codes."""
    xs, group = _prepared(CASES["flownet 5x128"])
    nchw = dataclasses.replace(group, in_offsets=None, tma8=None)
    _, offs, w8, _ = stripe_layout_q8(group.specs, group.in_channels, False)
    nchw = dataclasses.replace(nchw, offsets=offs, width8=w8)
    every = [dataclasses.replace(g, specs=tuple(dataclasses.replace(s, emit=True)
                                                for s in g.specs)) for g in (group, nchw)]
    got, ref = (conv_group_q8_plain(xs, g) for g in every)
    _equal(got, ref)
    for g, s in zip(got, group.specs):
        if s.q8:
            assert g.stride()[1] == 1 and g.stride()[3] == group.width8
    gen = torch.Generator().manual_seed(2)
    for dtype in (torch.float32, torch.bfloat16):
        # codes near every .5 boundary: the concat's one quantize == each input's
        raw = [((torch.rand(x.shape, generator=gen) * 300 - 150).round() + 0.5
                + torch.randn(x.shape, generator=gen) * 1e-3).to(dtype) * group.in_scale
               for x in xs]
        got = stripes_q8(raw, group).inputs
        assert all(torch.equal(g, quantize_q8(r, group.in_scale)) for g, r in zip(got, raw))
    floats = [x.float() * group.in_scale for x in xs]
    for given in (floats, xs):
        st = stripes_q8(given, group)
        assert st.s8.shape[1] == group.width8 and st.s8.is_contiguous(
            memory_format=torch.channels_last)
        assert all(torch.equal(v, x) for v, x in zip(st.inputs, xs))
        assert all(v.data_ptr() == st.s8[:, o].data_ptr()
                   for v, o in zip(st.inputs, group.in_offsets))
        assert all(v.data_ptr() != x.data_ptr() for v, x in zip(st.inputs, given))
    _equal(conv_group_q8(floats, group), conv_group_q8_plain(xs, group))
    _equal(conv_group_q8_plain(floats, group), conv_group_q8_plain(xs, group))


def test_layout_keeps_chunks_off_the_block_written():
    """Every q8 block starts on a multiple of 32 channels past each block
    its conv reads, so no chunk the conv loads reaches the block it writes;
    chunks cover every channel read, and the stripe is whole chunks."""
    for name in CASES:
        _, group = _prepared(CASES[name])
        assert group.width8 % TMA_Q8_CHUNK == 0
        for j, s in enumerate(group.specs):
            if not group.int8_read[j]:
                continue
            ranges = _read_ranges(s, group.in_offsets, group.offsets, group.in_channels,
                                  group.specs)
            chunks = tma_chunks_q8(ranges)
            covered = {c0 + i for c0 in chunks for i in range(TMA_Q8_CHUNK)}
            assert all(ch in covered for o, c in ranges for ch in range(o, o + c))
            assert max(chunks) + TMA_Q8_CHUNK <= group.width8
            if s.q8:
                assert group.offsets[j] % TMA_Q8_CHUNK == 0
                assert max(chunks) + TMA_Q8_CHUNK <= group.offsets[j]


def unpack_tma_weights_q8(packed, ranges, chunks, cout):
    """The inverse of ``pack_tma_weights_q8``: OIHW ``[cout, Cin, 3, 3]``;
    a block read twice takes its second run of chunks the second time."""
    nt, ntn = tma_q8_cout_tile(cout)
    g = packed.view(ntn, len(chunks), 9, 2, nt, TMA_Q8_KHALF).permute(0, 4, 2, 1, 3, 5)
    g = g.reshape(ntn * nt, 9, len(chunks) * TMA_Q8_CHUNK)[:cout]
    col, seen = [], {}
    for o, c in ranges:
        for ch in range(o, o + c):
            n = seen[ch] = seen.get(ch, -1) + 1
            i = [k for k, c0 in enumerate(chunks) if c0 == ch // TMA_Q8_CHUNK * TMA_Q8_CHUNK][n]
            col.append(i * TMA_Q8_CHUNK + ch % TMA_Q8_CHUNK)
    return g[:, :, col].reshape(cout, 3, 3, -1).permute(0, 3, 1, 2)


@pytest.mark.parametrize("ranges,cout", [([(0, 81), (81, 32), (113, 2), (115, 2)], 128),
                                         ([(96, 128), (0, 81)], 2), ([(0, 16)], 8),
                                         ([(64, 24), (0, 16), (16, 5)], 100),
                                         ([(0, 576)], 128), ([(32, 5)], 300),
                                         ([(32, 8), (0, 16), (40, 2), (32, 8)], 8)])
def test_tma_q8_packing_inverts(ranges, cout):
    """``pack_tma_weights_q8`` -> ``unpack_tma_weights_q8`` gives the
    weight back; every other row (channels not read, couts past ``cout``)
    is zero."""
    cin = sum(c for _, c in ranges)
    wq = torch.randint(-127, 128, (cout, cin, 3, 3),
                       generator=torch.Generator().manual_seed(cin + cout), dtype=torch.int8)
    wq[wq == 0] = 1
    chunks = tma_chunks_q8(ranges)
    packed = pack_tma_weights_q8(wq, ranges)
    nt, ntn = tma_q8_cout_tile(cout)
    assert packed.dtype == torch.int8
    assert packed.numel() == ntn * len(chunks) * 9 * TMA_Q8_CHUNK * nt
    assert torch.equal(unpack_tma_weights_q8(packed, ranges, chunks, cout), wq)
    assert int((packed != 0).sum()) == wq.numel()


def _stage_bytes(h, w, cout):
    """A ring stage's shared memory, as the kernel's launch reckons it: the
    window of 32-byte pixels and its slack (on 256 bytes), and the 9 taps'
    weights."""
    r, c, _, _ = tma_q8_tile(h, w)
    win = -(-TMA_Q8_CHUNK * ((c + 2) * (r + 2) + TMA_Q8_SLACK) // 256) * 256
    return win + 9 * TMA_Q8_CHUNK * tma_q8_cout_tile(cout)[0]


def _covers(h, w):
    """The tiles of ``tma_q8_tile`` cover an h x w image exactly once, and
    each tile's m64 blocks read inside its window and slack (the checks of
    the kernel's ``tile_ok``)."""
    r, c, mstride, mt = tma_q8_tile(h, w)
    bw = c + 2
    assert 1 <= mt <= 4 and mstride >= 64 and bw <= 256 and r + 2 <= 256
    assert (mt - 1) * mstride + 63 + 2 * bw + 2 < (r + 2) * bw + TMA_Q8_SLACK
    e = np.arange(r)[:, None] * bw + np.arange(c)[None, :]
    assert (e % mstride < 64).all() and (e // mstride < mt).all()
    cover = np.zeros((h, w), np.int64)
    for y0 in range(0, h, r):
        for x0 in range(0, w, c):
            cover[y0:y0 + r, x0:x0 + c] += 1
    assert (cover == 1).all(), (h, w)
    for cout in TMA_Q8_COUT_TILES:
        assert _stage_bytes(h, w, cout) <= TMA_Q8_STAGE_MAX


@pytest.mark.parametrize("h", [1, 3, 7, 14, 112])
def test_tiles_cover_and_fit(h):
    for w in range(1, 401):
        _covers(h, w)


def test_constants_match_the_kernel():
    """``TMA_Q8_*`` are the ``.cu``'s constants, and its entry point takes
    exactly the cout tiles the wrapper picks."""
    source = (_build._CSRC / "conv_group_q8_tma.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", source)}
    assert const["KC"] == TMA_Q8_CHUNK and const["KHALF"] == TMA_Q8_KHALF
    assert const["MAXCHUNK"] == TMA_Q8_MAX_CHUNKS and const["TILE_M"] == TMA_Q8_TILE
    assert const["SLACK"] == TMA_Q8_SLACK and const["STAGE_MAX"] == TMA_Q8_STAGE_MAX
    assert const["MSUB"] * 2 * 64 == TMA_Q8_TILE
    cases = {int(n) for n in re.findall(r"case (\d+): return launch<", source)}
    assert cases == set(TMA_Q8_COUT_TILES)


def test_routing_of_the_main_paths():
    """All 35 int8 convs of the W8A8 forward on the TMA kernel, at any size
    (448x1024, KITTI's 320x1216 with its levels 19, 38 and 76 wide); with
    ``'enc'`` and ``'ctx'`` the encoder's and context chain's groups (a
    stride-2 or dilated int8 conv each) keep the NCHW stripe and
    ``conv_group_q8.cu``: 35 of 59 on the TMA kernel, 24 on
    ``conv_group_q8.cu`` (14 of them staged). The backward decode of a
    ``q8_backward`` step is this serving decode: 35 of 35."""
    model = FlowNetCV(generator=torch.Generator().manual_seed(0))
    x = torch.rand(1, 64, 128, 6, generator=torch.Generator().manual_seed(1))
    for enc_ctx, want in ((False, (0, 0, 35)), (True, (24, 14, 35))):
        sc = pwc_fast.calibrate_q8(model, x, encoder=enc_ctx, ctx=enc_ctx, device="cpu")
        fw = pwc_fast.prepare(model, torch.bfloat16, "cpu", sc)
        for size in ((8, 448, 1024), (8, 320, 1216)):
            n = fw.launch_counts(size)
            assert (n["conv_group_q8"], n["conv_group_q8_staged"],
                    n["conv_group_q8_tma"]) == want
        nhwc = [g.nhwc for g in fw.groups() if hasattr(g, "nhwc")]
        assert nhwc == [False] * 6 * enc_ctx + [True] * 5 + [False] * enc_ctx


def test_decoder_group_matches_pallas():
    """One decoder-like group (a 117-channel input: the cost volume,
    features, up-flow and up-feat as one block, as the JAX decoder packs
    them; a growth conv and the flow head) through the emulated kernel
    == the JAX ``conv_group_q8`` in interpret mode."""
    rng = np.random.default_rng(3)
    b, h, w, c0 = 1, 4, 128, 117
    x = rng.normal(size=(b, c0, h, w)).astype(np.float32)
    growth = (32,)
    specs = [ConvSpec(tuple(range(1 + j)), g, q8=True) for j, g in enumerate(growth)]
    specs.append(ConvSpec((0, 1), 2, act=False, emit=True))
    blocks = [c0, *growth]
    weights = [[rng.normal(size=(3, 3, blocks[r], s.cout)) * 0.05 for r in s.reads]
               for s in specs]
    biases = [rng.normal(size=(s.cout,)) * 0.1 for s in specs]
    s_in = np.float32(np.abs(x).max() / 127.0)
    scales = [np.float32(0.05), None]
    group = prepare_group_q8([torch.cat([_oihw(a) for a in per], 1) for per in weights],
                             [torch.tensor(bb, dtype=torch.float32) for bb in biases],
                             specs, (c0,), s_in, scales, "cpu")
    assert group.nhwc
    (got,) = _tma_group_q8([quantize_q8(torch.from_numpy(x), s_in)], group)
    codes = jcc.quantize_q8(jnp.asarray(x.transpose(0, 2, 3, 1)), s_in)
    jspecs = [jcc.ConvSpec(reads=s.reads, cout=s.cout, dilation=s.dilation, act=s.act,
                           emit=s.emit, q8=s.q8, stride=s.stride) for s in specs]
    (ref,) = jcc.conv_group_q8(
        jcc.nhwc_to_flat(codes), s_in,
        [[jnp.asarray(a, jnp.float32) for a in per] for per in weights],
        [jnp.asarray(bb, jnp.float32) for bb in biases], jspecs, scales, h, w, th=4,
        interpret=True)
    assert got.dtype == torch.bfloat16 and got.shape == (b, 2, h, w)
    _bf16_close(got.float().numpy(), _unflat(ref, 2, h, w))
