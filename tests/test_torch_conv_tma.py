"""The TMA conv kernel's decomposition, emulated on the CPU.

``csrc/conv_group_tma.cu`` (bf16 convs of stride 1 and dilation 1 whose
rows TMA can read) cannot run here, so this file runs its loop in PyTorch,
tile by tile, with the kernel's own tile (``tma_tile_cols``: 256 output
pixels), chunks (``tma_chunks``: 16 channels of one segment), packing
(``pack_tma_weights``) and order: per chunk (one stage) the box of rows
y0 - 1 .. y0 + R at the tile's own columns, zero filled outside the image
and past a segment's channels, made the window of each tap column dx by a
one-pixel shift that takes the left or right 8-pixel strip's pixel; per
tap (dx, dy) the rows dy .. dy + R - 1 of that window against the packed
weight rows of the tap; fp32 partial sums per K split over the chunk
ranges the kernel gives each block, summed in split order; the epilogue
masked past H, W and cout. Held against ``conv_group_plain`` in
fp32 within 1e-5 of max|plain| (summation order only), and against the JAX
``conv_group`` in interpret mode on one decoder group within the 1e-4 of
tests/test_torch_kernels.py. The kernel itself is held against the plain
version on the card in tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ocflow_torch.kernels import conv_chain
from ocflow_torch.kernels.conv_chain import (TMA_CHUNK, TMA_TILE, ConvSpec,
                                             _block, _emitted, conv_group_plain,
                                             is_staged, is_tma, merge_segments, out_hw,
                                             pack_tma_weights, prepare_group, tma_chunks,
                                             tma_cout_row, tma_cout_tile, tma_segments,
                                             tma_split, tma_tile_cols, tma_units)
from ocflow_torch.models import FlowNetCV, pwc_fast
from ocflow_torch.models.pwc_net import CONTEXT, DECODER_LEVELS, LEVEL_FEATURES
from ocflow_tpu.ops.pallas import conv_chain_kernel as jcc
from test_torch_gpu import decoder_like_case, mixed_case
from test_torch_kernels import ATOL, _flat, _jax_specs, _unflat
from test_torch_ops import share_cores  # noqa: F401  (autouse)

REL_TOL = 1e-5


def _tma_rows(chans):
    """Per chunk, the conv's input channel of each of its ``TMA_CHUNK``
    K rows, -1 for the zero rows past a segment's end."""
    starts = [0]
    for c in chans:
        starts.append(starts[-1] + c)
    rows = []
    for seg, c0 in tma_chunks(chans):
        k = torch.arange(TMA_CHUNK) + c0
        rows.append(torch.where(k < chans[seg], k + starts[seg], -1))
    return torch.stack(rows)


def unpack_tma_weights(tp, chans, cout):
    """The inverse of ``pack_tma_weights``: OIHW ``[cout, Cin, 3, 3]``."""
    cin = sum(chans)
    nt, ntn = tma_cout_tile(cout)
    rows = _tma_rows(chans)
    g = tp.reshape(ntn, rows.shape[0], 9, TMA_CHUNK, tma_cout_row(nt))[..., :nt]
    g = g.permute(0, 4, 2, 1, 3).reshape(ntn * nt, 9, -1)[:cout]
    flat = rows.reshape(-1)
    w = g.new_zeros(cout, 9, cin)
    w[:, :, flat[flat >= 0]] = g[:, :, flat >= 0]
    return w.reshape(cout, 3, 3, cin).permute(0, 3, 1, 2)


def _read(seg, c0, nc, y0, nh, x0, nw):
    """``seg[:, c0:c0+nc, y0:y0+nh, x0:x0+nw]`` with zeros outside it: a
    TMA box and its out-of-bounds fill."""
    b, c, h, w = seg.shape
    box = seg.new_zeros(b, nc, nh, nw)
    cs, ce = max(c0, 0), min(c0 + nc, c)
    ys, ye = max(y0, 0), min(y0 + nh, h)
    xs, xe = max(x0, 0), min(x0 + nw, w)
    if cs < ce and ys < ye and xs < xe:
        box[:, cs - c0:ce - c0, ys - y0:ye - y0, xs - x0:xe - x0] = seg[:, cs:ce, ys:ye, xs:xe]
    return box


def _window(seg, c0, nc, y0, x0, tc, rows, dx):
    """A stage's window: the boxes at the tile's columns, shifted by the
    strip beside them for dx = 0 and 2. TMA refuses a box whose innermost
    coordinate is not a multiple of 16 bytes; every box here starts on 8
    pixels."""
    assert x0 % 8 == 0
    box = _read(seg, c0, nc, y0 - 1, rows + 2, x0, tc)
    if dx == 1:
        return box
    sx = x0 - 8 if dx == 0 else x0 + tc
    assert sx % 8 == 0
    strip = _read(seg, c0, nc, y0 - 1, rows + 2, sx, 8)
    if dx == 0:
        return torch.cat([strip[..., 7:], box[..., :-1]], -1)
    return torch.cat([box[..., 1:], strip[..., :1]], -1)


def _tma_conv(segs, tp, bias, out, spec, split=None):
    """One launch of the TMA kernel (and its split-K pass), emulated:
    writes ``out`` and returns how often each output pixel was written."""
    b, cout, h, w = out.shape
    assert all(tuple(s.shape[2:]) == (h, w) for s in segs)
    chans = [s.shape[1] for s in segs]
    chunks = tma_chunks(chans)
    nt, ntn = tma_cout_tile(cout)
    tc = tma_tile_cols(w)
    rows = TMA_TILE // tc
    if split is None:
        split = tma_split(b, h, w, cout, len(chunks))
    assert 1 <= split <= len(chunks)
    wt = tp.float().reshape(ntn, len(chunks), 9, TMA_CHUNK, tma_cout_row(nt))[..., :nt]
    wt = wt.transpose(3, 4)  # [cout tile, chunk, tap, nt, channel]
    nch = len(chunks)
    hits = torch.zeros(h, w, dtype=torch.int64)
    for y0 in range(0, h, rows):
        for x0 in range(0, w, tc):
            for n in range(ntn):
                parts = []
                for sp in range(split):
                    acc = torch.zeros(b, nt, rows, tc)
                    for ch in range(sp * nch // split, (sp + 1) * nch // split):
                        seg, c0 = chunks[ch]
                        for dx in range(3):
                            win = _window(segs[seg].float(), c0, TMA_CHUNK, y0, x0, tc,
                                          rows, dx)
                            for dy in range(3):
                                a = wt[n, ch, 3 * dy + dx]
                                acc += torch.einsum("nk,bkrc->bnrc", a, win[:, :, dy:dy + rows])
                    parts.append(acc)
                v = parts[0]
                for p in parts[1:]:  # the split-K pass: split order
                    v = v + p
                co = slice(n * nt, min((n + 1) * nt, cout))
                ye, xe = min(y0 + rows, h), min(x0 + tc, w)
                v = v[:, :co.stop - co.start, :ye - y0, :xe - x0] + bias[co, None, None]
                if spec.act:
                    v = F.leaky_relu(v, 0.1)
                out[:, co, y0:ye, x0:xe] = v.to(out.dtype)
                if n == 0:
                    hits[y0:ye, x0:xe] += 1
    return hits


def _tma_group(inputs, group, split=None):
    """``conv_group`` with every conv the TMA kernel takes on the emulated
    kernel (the others as plain convs); the stripe starts as NaN, so a pixel
    no tile writes shows."""
    ho, wo = out_hw([tuple(x.shape[2:]) for x in inputs], group.specs)
    b = inputs[0].shape[0]
    stripe = torch.full((b, group.width, ho, wo), float("nan"))
    ran = 0
    for j, s in enumerate(group.specs):
        reads = [_block(inputs, stripe, group, r) for r in s.reads]
        o = group.offsets[j]
        out = stripe[:, o:o + s.cout]
        segs = merge_segments(reads)
        if is_tma(torch.bfloat16, s, (ho, wo)):
            chans = tuple(t.shape[1] for t in segs)
            tp = pack_tma_weights(group.packed[j], chans, s.cout)
            sp = None if split is None else min(split, len(tma_chunks(chans)))
            hits = _tma_conv(segs, tp, group.biases[j], out, s, sp)
            assert bool((hits == 1).all()), f"conv {j}: pixels written {hits.unique()}"
            ran += 1
        else:
            y = F.conv2d(torch.cat(reads, 1), group.weights[j], group.biases[j],
                         stride=s.stride, padding=s.dilation, dilation=s.dilation)
            out.copy_(F.leaky_relu(y, 0.1) if s.act else y)
    assert ran, "no conv of the case takes the TMA kernel"
    return _emitted(stripe, group)


def _mixed_64(rng):
    """tests/test_torch_gpu.py's mixed case cut to 9x64 (TMA rows)."""
    ins, ws, bs, specs = mixed_case(rng)
    return [x[..., :64] for x in ins], ws, bs, specs


CASES = {
    "mixed 9x64": _mixed_64,
    # an 81-channel cost volume and 1-, 2-, 2-channel blocks; couts 128,
    # 196 (two cout tiles), 2 and 8; edge tiles in both directions
    "decoder 9x72": lambda rng: decoder_like_case(rng, 9, 72),
    "decoder 7x16": lambda rng: decoder_like_case(rng, 7, 16),
    "decoder 14x32": lambda rng: decoder_like_case(rng, 14, 32),
    "decoder 5x8": lambda rng: decoder_like_case(rng, 5, 8, c0=20),
    "decoder 3x136": lambda rng: decoder_like_case(rng, 3, 136, c0=40),
}


def _prepared(case, seed=7):
    rng = np.random.default_rng(seed)
    inputs, weights, biases, specs = case(rng)
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    group = prepare_group([t(w) for w in weights], [t(b) for b in biases],
                          specs, len(inputs), torch.float32, "cpu")
    return [t(x) for x in inputs], group


def _held(got, ref, tol=REL_TOL):
    for g, r in zip(got, ref, strict=True):
        err = (g - r).abs().max().item()
        assert err <= tol * r.abs().max().item(), err


@pytest.mark.parametrize("name", list(CASES))
def test_tma_decomposition_matches_plain(name):
    xs, group = _prepared(CASES[name])
    _held(_tma_group(xs, group), conv_group_plain(xs, group))


def _forward_splits(size=(8, 448, 1024)):
    """Every split factor ``tma_split`` picks for the TMA convs of the bf16
    forward at ``size``."""
    model = FlowNetCV(generator=torch.Generator().manual_seed(0))
    fw = pwc_fast.prepare(model, torch.bfloat16, "cpu")
    in_chs = [(3, *LEVEL_FEATURES[:-1])[i:i + 1] for i in range(len(fw.encoder))]
    in_chs += [pwc_fast._decoder_inputs(model, lvl) for lvl in DECODER_LEVELS]
    in_chs.append((CONTEXT[-2][0],))
    splits = set()
    for g, in_ch, (b, h, w) in zip(fw.groups(), in_chs, fw.group_shapes(size), strict=True):
        assert len(in_ch) == g.n_inputs
        for j, s in enumerate(g.specs):
            if is_tma(torch.bfloat16, s, (h, w)):
                chans = tma_segments(s, in_ch, g.specs)
                assert sum(chans) == g.weights[j].shape[1]
                splits.add(tma_split(b, h, w, s.cout, len(tma_chunks(chans))))
    return sorted(splits)


def test_forward_split_factors_match_plain():
    """Every split-K factor the router picks at the 448x1024 levels, forced
    on one decoder-like group: the fp32 partial sums summed in split order
    stay within summation order of the plain conv."""
    splits = _forward_splits()
    assert splits[0] == 1 and max(splits) > 4, splits
    xs, group = _prepared(CASES["decoder 7x16"], seed=3)
    ref = conv_group_plain(xs, group)
    for sp in splits:
        _held(_tma_group(xs, group, split=sp), ref)


def test_decoder_group_matches_pallas():
    """One decoder group (81-channel cost volume, 32-channel features,
    up-flow and up-feat, the five growth convs and the flow head) through
    the emulated kernel == the JAX ``conv_group`` in interpret mode."""
    rng = np.random.default_rng(5)
    b, h, w = 2, 8, 128  # the JAX kernel's rows: a multiple of 128 wide
    in_ch = (81, 32, 2, 2)
    inputs = [rng.normal(size=(b, c, h, w)).astype(np.float32) for c in in_ch]
    growth = (128, 128, 96, 64, 32)
    specs = [ConvSpec(tuple(range(4 + j)), g) for j, g in enumerate(growth)]
    specs.append(ConvSpec(tuple(range(4 + len(growth))), 2, act=False, emit=True))
    blocks = [*in_ch, *growth]
    weights = [[rng.normal(size=(3, 3, blocks[r], s.cout)) * (1 / np.sqrt(9 * 64))
                for r in s.reads] for s in specs]
    biases = [rng.normal(size=(s.cout,)) * 0.1 for s in specs]
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
    group = prepare_group([torch.cat([t(a).permute(3, 2, 0, 1) for a in per], 1)
                           for per in weights], [t(x) for x in biases], specs, 4,
                          torch.float32, "cpu")
    (got,) = _tma_group([t(x) for x in inputs], group)
    (ref,) = jcc.conv_group(
        [_flat(x) for x in inputs],
        [[jnp.asarray(a, jnp.float32) for a in per] for per in weights],
        [jnp.asarray(x, jnp.float32) for x in biases], _jax_specs(specs),
        h, w, th=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), _unflat(ref, 2, h, w), atol=ATOL)


@pytest.mark.parametrize("chans,cout", [((81, 32, 2, 2, 448), 128), ((16,), 16),
                                        ((196,), 196), ((565,), 2), ((2,), 8),
                                        ((33, 1, 64), 96), ((5,), 300)])
def test_tma_packing_inverts(chans, cout):
    """``pack_tma_weights`` -> ``unpack_tma_weights`` gives the OIHW weight
    back; the rows past a segment's channels and past cout are zeros."""
    g = torch.Generator().manual_seed(sum(chans) + cout)
    w = torch.randn(cout, sum(chans), 3, 3, generator=g)
    tp = pack_tma_weights(conv_chain.pack_weights(w, torch.float32), chans, cout)
    nt, ntn = tma_cout_tile(cout)
    assert tp.shape == (ntn * len(tma_chunks(chans)) * 9 * TMA_CHUNK, tma_cout_row(nt))
    assert torch.equal(unpack_tma_weights(tp, chans, cout), w)
    live = sum(min(TMA_CHUNK, c - c0) for c in chans for c0 in range(0, c, TMA_CHUNK))
    assert int((tp != 0).sum()) == live * 9 * cout


def test_tma_chunks_stay_in_one_segment():
    """Every channel of every segment in exactly one chunk, which starts
    inside its segment on a multiple of TMA_CHUNK."""
    for chans in [(81,), (81, 32, 2, 2), (1, 2, 128, 196), (565,)]:
        seen = set()
        for seg, c0 in tma_chunks(chans):
            assert 0 <= c0 < chans[seg] and c0 % TMA_CHUNK == 0
            seen |= {(seg, c) for c in range(c0, min(c0 + TMA_CHUNK, chans[seg]))}
        assert seen == {(s, c) for s, n in enumerate(chans) for c in range(n)}


def test_tma_segments_match_merge():
    """The packing's predicted segments are those ``merge_segments`` forms
    from a group's stripe blocks and separate inputs."""
    specs = [ConvSpec((0, 1), 32), ConvSpec((0, 1, 2), 16), ConvSpec((2, 0, 3, 1), 8)]
    in_ch = (81, 2)
    stripe = torch.zeros(1, 56, 4, 8)
    ins = [torch.zeros(1, c, 4, 8) for c in in_ch]
    offs = [0, 32, 48]
    for s in specs:
        views = [ins[r] if r < 2 else stripe[:, offs[r - 2]:offs[r - 2] + specs[r - 2].cout]
                 for r in s.reads]
        assert tma_segments(s, in_ch, specs) == tuple(
            t.shape[1] for t in merge_segments(views))


def test_routing_of_the_main_paths():
    """How many stride-1 bf16 convs take the TMA kernel: all 53 of the bf16
    forward and all 18 of the W8A8 forward at 8x448x1024; at KITTI's
    8x320x1216 none of the levels of width 76, 38 and 19 (rows of 152, 76
    and 38 bytes), which stay on the staged kernel."""
    model = FlowNetCV(generator=torch.Generator().manual_seed(0))
    fw = pwc_fast.prepare(model, torch.bfloat16, "cpu")
    want = {"conv_group": 59, "conv_group_staged": 53, "conv_group_q8": 0,
            "conv_group_q8_staged": 0}
    assert fw.launch_counts() == want
    assert fw.launch_counts((8, 448, 1024)) == {**want, "conv_group_tma": 53}
    assert fw.launch_counts((8, 320, 1216))["conv_group_tma"] == 23
    scales = pwc_fast.calibrate_q8(model.bfloat16(), torch.rand(
        2, 128, 128, 6, generator=torch.Generator().manual_seed(1)).bfloat16(), device="cpu")
    q8 = pwc_fast.prepare(model, torch.bfloat16, "cpu", scales).launch_counts((8, 448, 1024))
    assert (q8["conv_group_staged"], q8["conv_group_tma"]) == (18, 18)
    for wo in (8, 16, 32, 64, 128, 256, 512, 1216 // 4, 1216 // 8):
        assert is_tma(torch.bfloat16, ConvSpec((0,), 32), (64, wo))
    for wo in (19, 38, 76, 70, 9):
        assert not is_tma(torch.bfloat16, ConvSpec((0,), 32), (64, wo))
    for spec in (ConvSpec((0,), 32, stride=2), ConvSpec((0,), 32, dilation=2)):
        assert not is_tma(torch.bfloat16, spec, (64, 64))
        assert not is_staged(torch.bfloat16, spec)
    assert not is_tma(torch.float32, ConvSpec((0,), 32), (64, 64))


def test_split_choice():
    """Split K only where the tiles fill less than one wave of 132 SMs,
    never finer than one K chunk a block; a pure function of the shape."""
    assert tma_split(8, 112, 256, 128, 20) == 1          # 896 tiles
    assert tma_split(8, 56, 128, 128, 20) == 1           # 224 tiles
    assert tma_split(8, 28, 64, 128, 20) == 2            # 56 tiles
    assert tma_split(8, 14, 32, 128, 20) == 8            # 16 tiles
    assert tma_split(8, 7, 16, 128, 20) == 16            # 8 tiles
    assert tma_split(8, 7, 16, 128, 3) == 3              # 3 chunks
    assert tma_split(8, 7, 16, 8, 1) == 1                # one chunk
    assert tma_split(16, 7, 16, 196, 7) == 4             # 16 tiles x 2 cout tiles
    for b, h, w, cout, n in [(8, 7, 16, 32, 3), (2, 9, 72, 128, 9), (16, 14, 32, 196, 7)]:
        sp = tma_split(b, h, w, cout, n)
        assert 1 <= sp <= n
        assert sp == 1 or tma_units(b, h, w, cout) * sp <= 132
