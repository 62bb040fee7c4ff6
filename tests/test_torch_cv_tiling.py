"""The cost-volume kernels' tiling, emulated on the CPU.

``csrc/cost_volume.cu`` and ``csrc/cost_volume_bwd.cu`` run only on the
card. These tests replay their block decomposition in numpy (float64), with
the configurations read from the sources' ``#define`` lines: which rows and
columns each block stages (``stage_rows`` in ``csrc/cv_stage.cuh``, its
16-byte vector path and its element path), which shared-memory cells each
thread reads, the forward's shift-row groups, and the backward's ring of
feature rows and its shifted cotangent for df2. Each emulation is held
against the plain PyTorch version, at every d the kernels are built for
(1..10: the staged rows 32 + 2d rounded up to whole float4s, the forward's
last shift-row group with surplus rows where IS does not divide 2d+1), at
shapes whose rows are fewer than 2d+1, whose width is not a multiple of
the 32-column strip and whose channels are not a multiple of the chunk.
Tolerance 1e-12 (float64, summation order only).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ocflow_torch.kernels.cost_volume import (BACKWARD_DISPLACEMENTS, FORWARD_DISPLACEMENTS,
                                              cost_volume_backward_plain, cost_volume_plain)
from test_torch_ops import share_cores  # noqa: F401  (autouse)

CSRC = Path(__file__).resolve().parents[1] / "ocflow_torch" / "csrc"
TW = 32  # output columns per block, both kernels


def _pad(d: int) -> int:
    """2d rounded up to whole float4s (``PAD`` / ``kPad`` in the sources)."""
    return (2 * d + 3) // 4 * 4


def _config(source: str, macro: str) -> tuple[int, ...]:
    text = (CSRC / source).read_text()
    (values,) = re.findall(rf"^#define {macro} (.*)$", text, re.M)
    return tuple(int(v) for v in values.split(","))


def stage_elements(src, nch, nch_pad, nrows, win, y0, xs):
    """The element path of ``stage_rows``: dst[ch, row, u] = src[ch, y0 +
    row, xs[ch] + u], zero outside the image or for ch >= nch."""
    c, h, w = src.shape
    dst = np.zeros((nch_pad, nrows, win))
    ys = y0 + np.arange(nrows)[:, None]
    for ch in range(min(nch, c)):
        x = xs[ch] + np.arange(win)[None]
        inside = (ys >= 0) & (ys < h) & (x >= 0) & (x < w)
        dst[ch] = np.where(inside, src[ch, np.clip(ys, 0, h - 1), np.clip(x, 0, w - 1)], 0)
    return dst


def stage_vectors(src, nch, nch_pad, nrows, win, y0, xs, ve):
    """The 16-byte vector path of ``stage_rows`` (``ve`` elements a vector,
    W a multiple of ``ve``), item by item as the threads take them."""
    c, h, w = src.shape
    assert w % ve == 0
    nv = (win + ve - 1) // ve + 1
    dst = np.full((nch_pad, nrows, win), np.nan)
    for e in range(nch_pad * nrows * nv):
        slab, v = divmod(e, nv)
        ch, row = divmod(slab, nrows)
        xv = (xs[ch] & -ve) + v * ve
        if xv >= xs[ch] + win:
            continue
        y = y0 + row
        inside = ch < nch and 0 <= y < h and 0 <= xv < w
        vals = src[ch, y, xv:xv + ve] if inside else np.zeros(ve)
        for k in range(ve):
            u = xv + k - xs[ch]
            if 0 <= u < win:
                dst[ch, row, u] = vals[k]
    return dst


@pytest.mark.parametrize("ve", [4, 8])
@pytest.mark.parametrize("win, xstep", [(32, 0), (36, 0), (40, 0), (52, 0), (32, -1)])
def test_stage_vector_path_fills_the_window_as_the_element_path(ve, win, xstep):
    """Every cell of the window is written once, with the element path's
    value: starts left of the image, unaligned, and past its right edge;
    rows above and below it; channels past the last."""
    rng = np.random.default_rng(win + ve)
    src = rng.standard_normal((5, 6, 48))
    for x0 in (-10, -4, -1, 0, 3, 22, 40):
        xs = [x0 + ch * xstep for ch in range(6)]
        for y0 in (-2, 0, 3):
            want = stage_elements(src, 4, 6, 4, win, y0, xs)
            got = stage_vectors(src, 4, 6, 4, win, y0, xs, ve)
            np.testing.assert_array_equal(got, want)


def fwd_emulated(f1, f2, d, cfg):
    """``cost_volume_fwd_kernel``'s blocks: (image, 32-column strip, band of
    R rows, group of IS shift rows), channel chunks of CC, each thread P
    columns of one (row, shift row); the surplus rows of the last group are
    computed and not stored."""
    r_, is_, cc_, p_, *_ = cfg
    b_, c_, h, w = f1.shape
    n = 2 * d + 1
    assert is_ <= n and _pad(d) % p_ == 0
    win, r2, cgs = TW + _pad(d), r_ + is_ - 1, TW // p_
    out = np.zeros((b_, n * n, h, w))
    rr = np.arange(r_)[:, None, None, None]
    ii = np.arange(is_)[None, :, None, None]
    col = (np.arange(cgs)[:, None] * p_ + np.arange(p_))[None, None]
    for b in range(b_):
        for x0 in range(0, w, TW):
            for y0 in range(0, h, r_):
                for i0 in range(0, n, is_):
                    acc = np.zeros((n, r_, is_, cgs, p_))
                    for c0 in range(0, c_, cc_):
                        nch = min(cc_, c_ - c0)
                        s1 = stage_elements(f1[b, c0:], nch, cc_, r_, TW, y0, [x0] * cc_)
                        s2 = stage_elements(f2[b, c0:], nch, cc_, r2, win, y0 + i0 - d,
                                            [x0 - d] * cc_)
                        a = s1[:nch][:, rr, col]
                        for j in range(n):
                            acc[j] += (a * s2[:nch][:, rr + ii, col + j]).sum(0)
                    for r in range(r_):
                        for i in range(is_):
                            y = y0 + r
                            ks = (i0 + i) * n + np.arange(n)
                            xs = slice(x0, min(x0 + TW, w))
                            if y < h and i0 + i < n:
                                out[b, ks, y, xs] = acc[:, r, i].reshape(n, TW)[:, :w - x0] / c_
    return out


def bwd_emulated(f1, f2, g, d, cfg):
    """``cost_volume_bwd_kernel``'s blocks: (image, df1 or df2, 32-column
    strip, band of R rows, group of CB channels); 2d+1 steps over the shift
    rows (downwards for df2), the feature rows in a ring of R slots, one new
    row staged per step, the step's cotangent [N][R][32] (shifted by d-j
    columns for df2)."""
    r_, cb, _, p_, *_ = cfg
    b_, c_, h, w = f1.shape
    n = 2 * d + 1
    assert _pad(d) % p_ == 0
    win, cgs = TW + _pad(d), TW // p_
    outs = [np.zeros_like(f1), np.zeros_like(f1)]
    rr = np.arange(r_)[:, None, None]
    col = (np.arange(cgs)[:, None] * p_ + np.arange(p_))[None]
    for second, feat, out in ((False, f2, outs[0]), (True, f1, outs[1])):
        for b in range(b_):
            for c0 in range(0, c_, cb):
                nch = min(cb, c_ - c0)
                for x0 in range(0, w, TW):
                    for y0 in range(0, h, r_):
                        ring = np.full((cb, r_, win), np.nan)
                        slot_row = [None] * r_

                        def stage(q):
                            ring[:, q % r_] = stage_elements(feat[b, c0:], nch, cb, 1, win,
                                                             y0 - d + q, [x0 - d] * cb)[:, 0]
                            slot_row[q % r_] = q

                        for q in range(r_ - 1):
                            stage(q)
                        acc = np.zeros((cb, r_, cgs, p_))
                        for st in range(n):
                            i = n - 1 - st if second else st
                            stage(st + r_ - 1)
                            gk = g[b, i * n:(i + 1) * n]
                            if second:
                                sg = stage_elements(gk, n, n, r_, TW, y0 + d - i,
                                                    [x0 + d - j for j in range(n)])
                            else:
                                sg = stage_elements(gk, n, n, r_, TW, y0, [x0] * n)
                            slots = (np.arange(r_) + st) % r_
                            assert [slot_row[s] for s in slots] == list(range(st, st + r_))
                            rows = ring[:, slots]  # [cb, R, win], row r at slot (r+st) % R
                            for j in range(n):
                                shift = 2 * d - j if second else j
                                acc += sg[j][rr, col][None] * rows[:, rr, col + shift]
                        for c in range(nch):
                            for r in range(r_):
                                if y0 + r < h:
                                    xs = slice(x0, min(x0 + TW, w))
                                    out[b, c0 + c, y0 + r, xs] = \
                                        acc[c, r].reshape(TW)[:w - x0] / c_
    return outs


SHAPES = [(1, 20, 9, 40), (2, 13, 5, 70)]


def test_every_built_displacement_has_its_configuration_line():
    for d in FORWARD_DISPLACEMENTS:
        r_, is_, *_ = _config("cost_volume.cu", f"CV_FWD_D{d}")
        assert 1 <= is_ <= 2 * d + 1 and r_ * is_ * TW // 4 <= 1024
    # the backward: one configuration line, instantiated for every d
    assert len(_config("cost_volume_bwd.cu", "CV_BWD")) == 6
    bwd = (CSRC / "cost_volume_bwd.cu").read_text()
    for d in BACKWARD_DISPLACEMENTS:
        assert f"case {d}: return launch<{d}, CV_BWD>" in bwd, d
    assert FORWARD_DISPLACEMENTS == BACKWARD_DISPLACEMENTS == tuple(range(1, 11))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("d", FORWARD_DISPLACEMENTS)
def test_forward_tiling_matches_plain(d, shape):
    rng = np.random.default_rng(d)
    f1, f2 = rng.standard_normal(shape), rng.standard_normal(shape)
    got = fwd_emulated(f1, f2, d, _config("cost_volume.cu", f"CV_FWD_D{d}"))
    want = cost_volume_plain(torch.from_numpy(f1), torch.from_numpy(f2), d).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("d", BACKWARD_DISPLACEMENTS)
def test_backward_tiling_matches_plain(d, shape):
    rng = np.random.default_rng(d + 1)
    f1, f2 = rng.standard_normal(shape), rng.standard_normal(shape)
    b, _, h, w = shape
    g = rng.standard_normal((b, (2 * d + 1) ** 2, h, w))
    got = bwd_emulated(f1, f2, g, d, _config("cost_volume_bwd.cu", "CV_BWD"))
    want = cost_volume_backward_plain(*(torch.from_numpy(a) for a in (f1, f2, g)), d)
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt, wt.numpy(), rtol=0, atol=1e-12)
