"""The staged int8 conv kernel's decomposition, emulated on the CPU.

``csrc/conv_group_q8.cu:conv3x3_q8_staged_kernel`` (int8-read convs of
stride 1 and dilation 1) cannot run here, so this file runs its loop in
PyTorch, block by block, with the kernel's own tile (``staged_tile_q8``),
layout and order: per chunk of ``STAGE_Q8_CHUNK`` input channels a
zero-filled halo tile ``[STAGE_Q8_CHUNK][R+2][C+STAGE_Q8_EXTRA]`` staged from
the conv's int8 channel segments (the segment looked up once per channel and
chunk; halo position p holds input column ``ox0 - 16 + p``), per tap the
shifted window of that tile as the ``[32 x 128]`` X slab, the packed weight
``[cout_pad, 9, Cin32]`` (``pack_weights_q8``, zero past Cin), an exact
integer accumulation (float64 holds every sum here), and the requantizing
epilogue masked past Ho and Wo. A group runs its convs into its two stripes
as ``conv_group_q8`` does. Held against ``conv_group_q8_plain`` bit for bit
(``torch.equal``); that plain version is held against the Pallas kernel in
interpret mode in tests/test_torch_q8.py, and the kernel itself against the
plain version on the card in tests/test_torch_gpu.py.
"""

import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ocflow_torch.kernels import _build
from ocflow_torch.kernels.conv_chain import merge_segments, out_hw
from ocflow_torch.kernels.conv_chain_q8 import (QMAX, STAGE_Q8_ALIGN, STAGE_Q8_CHUNK,
                                                STAGE_Q8_EXTRA, STAGE_Q8_PIXELS,
                                                STAGE_Q8_PLANE_MAX, _block, _emitted,
                                                conv_group_q8_plain, is_staged_q8,
                                                pack_weights_q8, prepare_group_q8,
                                                quantize_q8, staged_tile_q8)
from test_torch_gpu import decoder_like_q8_case, mixed_q8_case
from test_torch_ops import share_cores  # noqa: F401  (autouse)


def _epilogue(acc, dq, bq, act, q8):
    """The plain version's epilogue on fp32 sums ``[B, cout, N]``."""
    v = acc * dq.view(1, -1, 1)
    v = v + bq.view(1, -1, 1)
    if act:
        v = torch.where(v >= 0, v, v * 0.1)
    return torch.round(v).clamp_(-QMAX, QMAX).to(torch.int8) if q8 else v.to(torch.bfloat16)


def _staged_conv_q8(segs, packed, dq, bq, out, spec):
    """One launch of the staged int8 kernel, emulated: writes ``out`` and
    returns how often each output pixel was written."""
    b, cout, ho, wo = out.shape
    h, w = segs[0].shape[2:]
    assert (h, w) == (ho, wo)
    cstart = np.cumsum([0, *[s.shape[1] for s in segs]])
    cin = int(cstart[-1])
    cin32 = -(-cin // STAGE_Q8_CHUNK) * STAGE_Q8_CHUNK
    assert packed.shape[1] == 9 * cin32
    wk = packed.view(packed.shape[0], 9, cin32).double()
    tr, tc = staged_tile_q8(wo)
    hr, hp = tr + 2, tc + STAGE_Q8_EXTRA
    n = torch.arange(STAGE_Q8_PIXELS)
    pr, pc = n // tc, n % tc              # the X-slab column's pixel in the tile
    nvalid = n < tr * tc
    hits = torch.zeros(ho, wo, dtype=torch.int64)
    for ty in range(-(-ho // tr)):
        for tx in range(-(-wo // tc)):
            oy0, ox0 = ty * tr, tx * tc
            acc = torch.zeros(b, packed.shape[0], STAGE_Q8_PIXELS, dtype=torch.float64)
            for c0 in range(0, cin, STAGE_Q8_CHUNK):
                # rows oy0-1 .. oy0+tr; positions 15 .. tc+16 are staged
                halo = torch.zeros(b, STAGE_Q8_CHUNK, hr, hp, dtype=torch.float64)
                for cl in range(min(STAGE_Q8_CHUNK, cin - c0)):
                    c = c0 + cl
                    s = int(np.searchsorted(cstart, c, side="right")) - 1
                    plane = segs[s][:, c - cstart[s]]
                    y0, y1 = max(oy0 - 1, 0), min(oy0 + tr + 1, h)
                    x0, x1 = max(ox0 - 1, 0), min(ox0 + tc + 1, w)
                    halo[:, cl, y0 - oy0 + 1:y1 - oy0 + 1,
                         x0 - ox0 + 16:x1 - ox0 + 16] = plane[:, y0:y1, x0:x1].double()
                for tap in range(9):
                    dy, dx = divmod(tap, 3)
                    rows = (pr + dy).clamp(max=hr - 1)  # invalid columns: zeros
                    xs = torch.where(nvalid, halo[:, :, rows, pc + dx + 15], 0.0)
                    acc += torch.einsum("mk,bkn->bmn",
                                        wk[:, tap, c0:c0 + STAGE_Q8_CHUNK], xs)
            oy, ox = oy0 + pr, ox0 + pc
            ok = nvalid & (oy < ho) & (ox < wo)
            out[:, :, oy[ok], ox[ok]] = _epilogue(acc[:, :cout, ok].float(), dq, bq,
                                                  spec.act, spec.q8)
            hits[oy[ok], ox[ok]] += 1
    return hits


def _staged_group_q8(inputs, group):
    """``conv_group_q8`` with each int8-read conv of stride 1 and dilation 1
    on the emulated staged kernel, the others as the plain version computes
    them; the bf16 stripe starts as NaN, so a pixel no tile writes shows
    (and ``hits`` counts the int8 stripe's)."""
    ho, wo = out_hw([tuple(x.shape[2:]) for x in inputs], group.specs)
    b = inputs[0].shape[0]
    s8 = torch.zeros((b, group.width8, ho, wo), dtype=torch.int8)
    s16 = torch.full((b, group.width16, ho, wo), float("nan"), dtype=torch.bfloat16)
    for j, s in enumerate(group.specs):
        reads = [_block(inputs, s8, s16, group, r) for r in s.reads]
        out = _block(inputs, s8, s16, group, group.n_inputs + j)
        conv = dict(stride=s.stride, padding=s.dilation, dilation=s.dilation)
        if group.int8_read[j] and is_staged_q8(s):
            packed = pack_weights_q8(group.weights[j], True)  # the staged kernel's packing
            hits = _staged_conv_q8(merge_segments(reads), packed,
                                   group.dq[j], group.bq[j], out, s)
            assert bool((hits == 1).all()), f"conv {j}: pixels written {hits.unique()}"
        elif group.int8_read[j]:
            acc = F.conv2d(torch.cat(reads, 1).double(), group.weights[j].double(), **conv)
            out.copy_(_epilogue(acc.float().flatten(2), group.dq[j], group.bq[j],
                                s.act, s.q8).view(out.shape))
        else:
            v = F.conv2d(torch.cat(reads, 1).float(), group.weights[j].float(),
                         group.bq[j], **conv)
            out.copy_((F.leaky_relu(v, 0.1) if s.act else v).to(torch.bfloat16))
    return _emitted(s8, s16, group)


CASES = {  # the card test's staged cases (tests/test_torch_gpu.py:_q8_cases)
    "9x70": mixed_q8_case,
    "7x16": lambda rng: decoder_like_q8_case(rng, 7, 16),
    "5x64": lambda rng: decoder_like_q8_case(rng, 5, 64),
    "3x136": lambda rng: decoder_like_q8_case(rng, 3, 136),
    # FlowNetCV's decoder widths, a few rows each (partial tiles at 64, 32, 16)
    **{f"{h}x{w}": (lambda rng, h=h, w=w: decoder_like_q8_case(rng, h, w, c0=20))
       for h, w in ((2, 256), (2, 128), (3, 64), (5, 32), (9, 16))},
}


@pytest.mark.parametrize("name", list(CASES))
def test_staged_q8_decomposition_matches_plain(name):
    rng = np.random.default_rng(7)
    inputs, weights, biases, specs, s_in, scales = CASES[name](rng)
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    group = prepare_group_q8([t(w) for w in weights], [t(b) for b in biases], specs,
                             [x.shape[1] for x in inputs], s_in, scales, "cpu")
    assert any(r and is_staged_q8(s) for r, s in zip(group.int8_read, specs))
    xs = [quantize_q8(t(x), s_in) for x in inputs]
    got = _staged_group_q8(xs, group)
    ref = conv_group_q8_plain(xs, group)
    for g, r in zip(got, ref, strict=True):
        assert g.dtype == r.dtype and torch.equal(g, r), (
            name, (g.float() - r.float()).abs().max().item())


@pytest.mark.parametrize("ho", [1, 7, 9, 112])
def test_staged_q8_tiles_cover_and_fit(ho):
    """Every width up to 600: the tile holds at most 128 pixels, its width
    is a multiple of 16 (the kernel's 16-byte staging), its halo fits the
    kernel's shared memory, and the tiles of an image cover each output
    pixel exactly once."""
    for wo in range(1, 601):
        tr, tc = staged_tile_q8(wo)
        assert tr >= 1 and tr * tc <= STAGE_Q8_PIXELS
        assert tc >= STAGE_Q8_ALIGN and tc % STAGE_Q8_ALIGN == 0
        assert (tr + 2) * (tc + STAGE_Q8_EXTRA) <= STAGE_Q8_PLANE_MAX
        cover = np.zeros((ho, wo), np.int64)
        for oy0 in range(0, ho, tr):
            for ox0 in range(0, wo, tc):
                cover[oy0:oy0 + tr, ox0:ox0 + tc] += 1
        assert (cover == 1).all(), wo


def test_stage_constants_match_the_kernel():
    """``STAGE_Q8_*`` are the ``.cu``'s ``ST_*`` (and its pixel tile ``BN``)."""
    source = (_build._CSRC / "conv_group_q8.cu").read_text()
    const = dict(re.findall(r"constexpr int (\w+) = (\w+);", source))
    assert const["ST_CC"] == "BK" and int(const["BK"]) == STAGE_Q8_CHUNK
    assert int(const["BN"]) == STAGE_Q8_PIXELS
    assert int(const["ST_ALIGN"]) == STAGE_Q8_ALIGN
    assert int(const["ST_EXTRA"]) == STAGE_Q8_EXTRA
    assert int(const["ST_PLANE_MAX"]) == STAGE_Q8_PLANE_MAX


def test_fast_division_is_exact_for_the_q8_tiles():
    """The kernels' ``FastDiv`` (``__umulhi(n, 0xffffffff / d + 1)``) equals
    n // d for every divisor and dividend the int8 staging takes: rows by
    ``R+2``, bytes by ``C+2`` (byte path), vectors by ``(C+32)/16``."""
    checked = set()
    for wo in range(1, 129):
        tr, tc = staged_tile_q8(wo)
        hr = tr + 2
        vr = (tc + STAGE_Q8_EXTRA) // 16
        for d, n_max in ((hr, STAGE_Q8_CHUNK * hr), (tc + 2, STAGE_Q8_CHUNK * hr * (tc + 2)),
                         (vr, STAGE_Q8_CHUNK * hr * vr)):
            assert d >= 2
            if (d, n_max) in checked:
                continue
            checked.add((d, n_max))
            n = np.arange(n_max, dtype=np.uint64)
            m = np.uint64(0xFFFFFFFF // d + 1)
            assert np.array_equal((n * m) >> np.uint64(32), n // np.uint64(d)), d
