"""The staged bf16 conv kernel's decomposition, emulated on the CPU.

``csrc/conv_group.cu:conv3x3_bf16_staged_kernel`` (bf16 convs of stride 1
and dilation 1) cannot run here, so this file runs its loop in PyTorch,
block by block, with the kernel's own tile (``staged_tile``), layout and
order: per chunk of ``STAGE_CHUNK`` input channels a zero-filled halo tile
``[STAGE_CHUNK][R+2][C+STAGE_EXTRA]`` staged from the conv's channel
segments (the segment looked up once per channel and chunk), per tap the
shifted window of that tile as the ``[32 x 128]`` X slab, the packed
weight's rows ``tap*Cin + c`` (zero past Cin, never read), fp32
accumulation, and the epilogue masked past Ho and Wo. A group runs its convs
into one stripe as ``conv_group`` does. Held against ``conv_group_plain``
in fp32 within 1e-5 of max|plain| (summation order only). The kernel itself
is held against the plain version on the card in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ocflow_torch.kernels import _build
from ocflow_torch.kernels.conv_chain import (STAGE_CHUNK, STAGE_EXTRA, STAGE_HALO,
                                             STAGE_MAX_ROWS, STAGE_PIXELS, _block,
                                             _emitted, conv_group_plain,
                                             merge_segments, out_hw, prepare_group,
                                             staged_tile)
from ocflow_torch.tools.conv_ablation import REMOVALS, _removed
from test_torch_gpu import decoder_like_case, mixed_case
from test_torch_ops import share_cores  # noqa: F401  (autouse)

REL_TOL = 1e-5


def _staged_conv(segs, packed, bias, out, act):
    """One launch of the staged kernel, emulated: writes ``out`` and
    returns how often each output pixel was written."""
    b, cout, ho, wo = out.shape
    h, w = segs[0].shape[2:]
    assert (h, w) == (ho, wo)
    cstart = np.cumsum([0, *[s.shape[1] for s in segs]])
    cin = int(cstart[-1])
    tr, tc = staged_tile(wo)
    hr, hp = tr + 2, tc + STAGE_EXTRA
    n = torch.arange(STAGE_PIXELS)
    pr, pc = n // tc, n % tc              # the X-slab column's pixel in the tile
    nvalid = n < tr * tc
    kk = torch.arange(STAGE_CHUNK)
    hits = torch.zeros(ho, wo, dtype=torch.int64)
    for ty in range(-(-ho // tr)):
        for tx in range(-(-wo // tc)):
            oy0, ox0 = ty * tr, tx * tc
            acc = torch.zeros(b, packed.shape[1], STAGE_PIXELS)
            for c0 in range(0, cin, STAGE_CHUNK):
                # halo position p of a row holds input column ox0 - 8 + p;
                # rows oy0-1 .. oy0+tr; positions 7 .. tc+8 are staged
                halo = torch.zeros(b, STAGE_CHUNK, hr, hp)
                for cl in range(STAGE_CHUNK):
                    c = c0 + cl
                    if c >= cin:
                        continue
                    s = int(np.searchsorted(cstart, c, side="right")) - 1
                    plane = segs[s][:, c - cstart[s]]
                    y0, y1 = max(oy0 - 1, 0), min(oy0 + tr + 1, h)
                    x0, x1 = max(ox0 - 1, 0), min(ox0 + tc + 1, w)
                    halo[:, cl, y0 - oy0 + 1:y1 - oy0 + 1,
                         x0 - ox0 + 8:x1 - ox0 + 8] = plane[:, y0:y1, x0:x1]
                live = c0 + kk < cin
                for tap in range(9):
                    dy, dx = divmod(tap, 3)
                    rows = (pr + dy).clamp(max=hr - 1)  # invalid columns: zeros
                    xs = torch.where(nvalid, halo[:, :, rows, pc + dx + 7], 0.0)
                    a = torch.zeros(STAGE_CHUNK, packed.shape[1])
                    a[live] = packed[tap * cin + c0 + kk[live]].float()
                    acc += torch.einsum("km,bkn->bmn", a, xs)
            oy, ox = oy0 + pr, ox0 + pc
            ok = nvalid & (oy < ho) & (ox < wo)
            v = acc[:, :cout, ok] + bias[None, :, None]
            if act:
                v = F.leaky_relu(v, 0.1)
            out[:, :, oy[ok], ox[ok]] = v.to(out.dtype)
            hits[oy[ok], ox[ok]] += 1
    return hits


def _staged_group(inputs, group):
    """``conv_group`` with each stride-1, dilation-1 conv on the emulated
    staged kernel (the others as plain convs); the stripe starts as NaN, so
    a pixel no tile writes shows."""
    ho, wo = out_hw([tuple(x.shape[2:]) for x in inputs], group.specs)
    stripe = torch.full((inputs[0].shape[0], group.width, ho, wo), float("nan"))
    for j, s in enumerate(group.specs):
        reads = [_block(inputs, stripe, group, r) for r in s.reads]
        o = group.offsets[j]
        out = stripe[:, o:o + s.cout]
        if s.stride == 1 and s.dilation == 1:
            hits = _staged_conv(merge_segments(reads), group.packed[j],
                                group.biases[j], out, s.act)
            assert bool((hits == 1).all()), f"conv {j}: pixels written {hits.unique()}"
        else:
            y = F.conv2d(torch.cat(reads, 1), group.weights[j], group.biases[j],
                         stride=s.stride, padding=s.dilation, dilation=s.dilation)
            out.copy_(F.leaky_relu(y, 0.1) if s.act else y)
    return _emitted(stripe, group)


CASES = {  # the card test's staged cases (tests/test_torch_gpu.py:_cases)
    "9x70": mixed_case,
    "7x16": lambda rng: decoder_like_case(rng, 7, 16),
    "5x64": lambda rng: decoder_like_case(rng, 5, 64),
    "3x136": lambda rng: decoder_like_case(rng, 3, 136),
    # FlowNetCV's widths, a few rows each (partial tiles at 64, 32, 16)
    **{f"{h}x{w}": (lambda rng, h=h, w=w: decoder_like_case(rng, h, w, c0=20))
       for h, w in ((2, 512), (3, 256), (2, 128), (3, 64), (5, 32), (7, 16))},
}


@pytest.mark.parametrize("name", list(CASES))
def test_staged_decomposition_matches_plain(name):
    rng = np.random.default_rng(7)
    inputs, weights, biases, specs = CASES[name](rng)
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    group = prepare_group([t(w) for w in weights], [t(b) for b in biases],
                          specs, len(inputs), torch.float32, "cpu")
    xs = [t(x) for x in inputs]
    got = _staged_group(xs, group)
    ref = conv_group_plain(xs, group)
    for g, r in zip(got, ref, strict=True):
        err = (g - r).abs().max().item()
        assert err <= REL_TOL * r.abs().max().item(), (name, err)


@pytest.mark.parametrize("ho", [1, 7, 9, 112])
def test_staged_tiles_cover_and_fit(ho):
    """Every width up to 600: the tile holds at most 128 pixels and 16 rows,
    its width is a multiple of 8 (the kernel's window copy), its halo fits
    the kernel's shared memory, and the tiles of an image cover each output
    pixel exactly once."""
    for wo in range(1, 601):
        tr, tc = staged_tile(wo)
        assert 1 <= tr <= STAGE_MAX_ROWS and tr * tc <= STAGE_PIXELS
        assert tc >= 8 and tc % 8 == 0
        assert STAGE_CHUNK * (tr + 2) * (tc + STAGE_EXTRA) <= STAGE_HALO
        cover = np.zeros((ho, wo), np.int64)
        for oy0 in range(0, ho, tr):
            for ox0 in range(0, wo, tc):
                cover[oy0:oy0 + tr, ox0:ox0 + tc] += 1
        assert (cover == 1).all(), wo


def test_ablation_removals_match_the_kernel():
    """Each part ``tools.conv_ablation`` takes out of the staged kernel is
    in the kernel's source exactly once (the tool times what is left), in
    the bf16 kernel's and, for ``--q8``, in the int8 kernel's."""
    for q8, name in ((False, "conv_group.cu"), (True, "conv_group_q8.cu")):
        source = (_build._CSRC / name).read_text()
        for part in REMOVALS:
            # raises unless each text is there once
            assert _removed(part, q8) != source


def test_fast_division_is_exact():
    """The kernel's ``FastDiv`` (``__umulhi(n, 0xffffffff / d + 1)``) equals
    n // d for every divisor and dividend the staging takes: rows by
    ``R+2``, elements by ``C+2`` (2-byte path), vectors by ``(C+16)/8``."""
    checked = set()
    for wo in range(1, 129):
        tr, tc = staged_tile(wo)
        hr = tr + 2
        for d, n_max in ((hr, STAGE_CHUNK * hr), (tc + 2, STAGE_CHUNK * hr * (tc + 2)),
                         ((tc + STAGE_EXTRA) // 8, STAGE_CHUNK * hr * (tc + STAGE_EXTRA) // 8)):
            assert d >= 2
            if (d, n_max) in checked:
                continue
            checked.add((d, n_max))
            n = np.arange(n_max, dtype=np.uint64)
            m = np.uint64(0xFFFFFFFF // d + 1)
            assert np.array_equal((n * m) >> np.uint64(32), n // np.uint64(d)), d
