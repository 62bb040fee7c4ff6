"""The cost volume past the tuned kernels' d = 10, on the CPU.

The port's cost volume at d = 11 and 12 (the plain version, which CPU
tensors take) against the JAX package's ``cost_volume_fused`` (its XLA cost
volume there, as at any d its Pallas block does not fit) and that op's VJP
(``_bwd_xla_mirror``), within 1e-5 of max|JAX|.

The general CUDA kernels of ``csrc/cost_volume_any.cu`` run only on the
card (``tests/test_torch_gpu.py`` holds them against the plain version).
Here their decomposition is replayed in numpy (float64), with the
configurations read from the source's ``CV_ANY_FWD`` / ``CV_ANY_BWD`` lines:
the forward's blocks of shift rows and shift columns (the last groups' surplus
computed and not stored), its staged tiles from aligned columns and each
thread's window at its offset e; the backward's ring of R+1 feature rows
with a slice of the next row staged with each unit, its groups of shift
columns, the df2 cotangent staged unshifted and read at j' - j'0 + e, its
passes where the ring would not fit; the 16-byte vector path of the staging
(aligned vectors wholly inside or outside the image) and its element path.
Every cell a thread reads must have been staged (cells start as NaN). Each
replay is held against the plain version at 1e-12 (summation order only),
at shapes whose rows are fewer than 2d+1, whose width is not a multiple of
the 32-column strip and whose channels are not a multiple of the chunk.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocflow_torch.kernels import cost_volume as cv_mod
from ocflow_tpu.ops.pallas import cost_volume_kernel as jcv
from test_torch_ops import share_cores  # noqa: F401  (autouse)

TOL = 1e-5
SOURCE = Path(__file__).resolve().parents[1] / "ocflow_torch" / "csrc" / "cost_volume_any.cu"
TW = 32            # output columns per block
MAX_SMEM = 232448  # a block's shared memory on the H100
# [B, C, H, W], one per staging path: W a multiple of 4 (vectors), and not (elements)
PATH_SHAPES = {"vector": (2, 13, 9, 44), "element": (1, 11, 7, 45)}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _inputs(d, shape, seed=0):
    rng = np.random.default_rng(seed)
    f1 = rng.standard_normal(shape).astype(np.float32)
    f2 = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal((*shape[:3], (2 * d + 1) ** 2)).astype(np.float32)
    return f1, f2, g


def _close(got, want):
    want = np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("d, shape", [(11, (2, 20, 28, 16)), (12, (1, 26, 30, 13))])
def test_cost_volume_past_d10_matches_jax(d, shape):
    """Forward and VJP; at d = 12 the 30-wide map is narrower than the
    25 x 25 shift window's reach on each side of most pixels."""
    f1, f2, g = _inputs(d, shape)
    want, vjp = jax.vjp(lambda a, b: jcv.cost_volume_fused(a, b, d),
                        jnp.asarray(f1), jnp.asarray(f2))
    t1, t2 = _nchw(f1).requires_grad_(), _nchw(f2).requires_grad_()
    got = cv_mod.cost_volume(t1, t2, d)
    _close(_nhwc(got), want)
    got.backward(_nchw(g))
    for a, b in zip((t1.grad, t2.grad), vjp(jnp.asarray(g))):
        _close(_nhwc(a), b)


def _round4(v):
    return (v + 3) // 4 * 4


def _config(macro):
    (values,) = re.findall(rf"^#define {macro} (.*)$", SOURCE.read_text(), re.M)
    return tuple(int(v) for v in values.split(","))


def stage(src, c0, nch, cap, nrows, win, y0, xa, vec, sch=1):
    """A tile as the kernel stages it: dst[ch, row, u] = src[c0 + ch * sch,
    y0 + row, xa + u], zero where ch >= nch or outside the image. ``vec``:
    the 16-byte path, 4-element vectors from an aligned column, each wholly
    inside or outside the image; else element by element."""
    c_, h, w = src.shape
    dst = np.full((cap, nrows, win), np.nan)
    ch, row, u = np.meshgrid(np.arange(cap), np.arange(nrows), np.arange(win), indexing="ij")
    if vec:
        assert xa % 4 == 0 and win % 4 == 0 and w % 4 == 0
        ch, row, u = ch[..., ::4], row[..., ::4], u[..., ::4]  # one item a vector
    x, y = xa + u, y0 + row
    inside = (ch < nch) & (y >= 0) & (y < h) & (x >= 0) & (x < w)
    c = np.clip(c0 + ch * sch, 0, c_ - 1)
    assert ((c0 + ch * sch == c) | ~inside).all()
    y = np.clip(y, 0, h - 1)
    for k in range(4 if vec else 1):
        if vec:  # a vector lies whole inside or outside
            assert not (inside & (x + k >= w)).any()
        dst[ch, row, u + k] = np.where(inside, src[c, y, np.clip(x + k, 0, w - 1)], 0)
    return dst


def fwd_emulated(f1, f2, d, cfg, vec):
    """``cost_volume_any_fwd_kernel``: blocks of (image, strip, band of R
    rows, IS shift rows, JS shift columns), chunks of CC channels; f2's tile
    from column x0 + j0 - d - e (e = (j0 - d) mod 4), a thread's window of
    round4(P + JS - 1 + e) columns from its aligned column, read at e + p + j."""
    r_, is_, js, cc_, p_, *_ = cfg
    b_, c_, h, w = f1.shape
    n = 2 * d + 1
    win, r2, cgs = _round4(TW + js + 2), r_ + is_ - 1, TW // p_
    out = np.full((b_, n * n, h, w), np.nan)
    rr = np.arange(r_)[:, None, None, None]
    ii = np.arange(is_)[None, :, None, None]
    col = (np.arange(cgs)[:, None] * p_ + np.arange(p_))[None, None]
    base = (np.arange(cgs)[:, None] * p_)[None, None]
    for b in range(b_):
        for x0 in range(0, w, TW):
            for i0 in range(0, n, is_):
                for j0 in range(0, n, js):
                    e = (j0 - d) % 4
                    nw = _round4(p_ + js - 1 + e)
                    assert base.max() + nw <= win
                    for y0 in range(0, h, r_):
                        acc = np.zeros((js, r_, is_, cgs, p_))
                        for c0 in range(0, c_, cc_):
                            nch = min(cc_, c_ - c0)
                            s1 = stage(f1[b], c0, nch, cc_, r_, TW, y0, x0, vec)
                            s2 = stage(f2[b], c0, nch, cc_, r2, win, y0 + i0 - d,
                                       x0 + j0 - d - e, vec)
                            a = s1[:, rr, col]
                            for j in range(js):
                                acc[j] += (a * s2[:, rr + ii, col + e + j]).sum(0)
                        for r in range(r_):
                            for i in range(is_):
                                for j in range(js):
                                    y, xs = y0 + r, slice(x0, min(x0 + TW, w))
                                    if y < h and i0 + i < n and j0 + j < n:
                                        out[b, (i0 + i) * n + j0 + j, y, xs] = \
                                            acc[j, r, i].reshape(TW)[:w - x0] / c_
    return out


def bwd_smem(cfg, span):
    """``bwd_smem`` for fp32: the ring [CB][R+1][36 + span*JS] and two
    cotangent buffers [JS][R][36 + JS]."""
    r_, cb, _, js, *_ = cfg
    return 4 * cb * (r_ + 1) * (TW + 4 + span * js) + 4 * 2 * js * r_ * (TW + 4 + js)


def bwd_span(cfg, d, max_smem=MAX_SMEM):
    js = cfg[3]
    span = -(-(2 * d + 1) // js)
    while span > 1 and bwd_smem(cfg, span) > max_smem:
        span -= 1
    return span


def bwd_emulated(f1, f2, g, d, cfg, vec, span=None):
    """``cost_volume_any_bwd_kernel``: blocks of (image, df1 or df2, strip,
    band of R rows, CB channels); per pass of ``span`` groups of JS shift
    columns, R feature rows staged into a ring of R+1 slots, then units
    (step st over the shift rows, downwards for df2; group jg): the FMAs on
    the unit's cotangent buffer and the ring, then the next unit's
    cotangent into the other buffer and slice jg - g0 of the next step's row
    into its slot."""
    r_, cb, ch_, js, p_, *_ = cfg
    b_, c_, h, w = f1.shape
    n = 2 * d + 1
    nj = -(-n // js)
    span = bwd_span(cfg, d) if span is None else span
    e = (-d) % 4
    rw, cgs = TW + 4 + span * js, TW // p_
    assert cb % ch_ == 0 and js % 4 == 0
    outs = [np.full_like(f1, np.nan), np.full_like(f1, np.nan)]
    rr = np.arange(r_)[:, None, None]
    col = (np.arange(cgs)[:, None] * p_ + np.arange(p_))[None]
    for second, feat, out in ((False, f2, outs[0]), (True, f1, outs[1])):
        gw = TW + 4 + js if second else TW
        nw = _round4(p_ + js - 1 + e)
        for b in range(b_):
            for c0 in range(0, c_, cb):
                nch = min(cb, c_ - c0)
                for x0 in range(0, w, TW):
                    for y0 in range(0, h, r_):
                        acc = np.zeros((cb, r_, cgs, p_))
                        for g0 in range(0, nj, span):
                            g1 = min(nj, g0 + span)
                            sw = _round4(-(-rw // (g1 - g0)))
                            ring = np.full((cb, r_ + 1, rw), np.nan)
                            slot_row = [None] * (r_ + 1)

                            def ring_row(q, u0, u1):
                                if u1 > u0:
                                    ring[:, q % (r_ + 1), u0:u1] = stage(
                                        feat[b], c0, nch, cb, 1, u1 - u0, y0 - d + q,
                                        x0 - d + g0 * js - e + u0, vec)[:, 0]
                                slot_row[q % (r_ + 1)] = q

                            def unit(st, jg):
                                i, jp = (n - 1 - st if second else st), jg * js
                                if second:  # channel i*n + n-1-j', unshifted
                                    return stage(g[b], i * n + n - 1 - jp, min(js, n - jp), js,
                                                 r_, gw, y0 + d - i, x0 - d + jp - e, vec,
                                                 sch=-1)
                                return stage(g[b], i * n + jp, min(js, n - jp), js, r_, gw,
                                             y0, x0, vec)

                            for q in range(r_):
                                ring_row(q, 0, rw)
                            bufs = [unit(0, g0), None]
                            u = 0
                            for st in range(n):
                                for jg in range(g0, g1):
                                    gs = bufs[u & 1]
                                    gv = np.stack([gs[jj][rr, col + (jj + e if second else 0)]
                                                   for jj in range(js)])
                                    slots = [(st + r) % (r_ + 1) for r in range(r_)]
                                    assert [slot_row[s] for s in slots] == \
                                        list(range(st, st + r_))
                                    off = (jg - g0) * js
                                    assert off + col.max() - p_ + 1 + nw <= rw
                                    rows = ring[:, slots]  # [cb, R, rw]
                                    for jj in range(js):
                                        acc += gv[jj][None] * rows[:, rr, col + off + e + jj]
                                    last = jg + 1 == g1
                                    if (st + 1 if last else st) < n:
                                        bufs[(u + 1) & 1] = unit(st + 1 if last else st,
                                                                 g0 if last else jg + 1)
                                    if st + 1 < n:
                                        k = jg - g0
                                        ring_row(st + r_, min(k * sw, rw), min((k + 1) * sw, rw))
                                    u += 1
                        for c in range(nch):
                            for r in range(r_):
                                if y0 + r < h:
                                    xs = slice(x0, min(x0 + TW, w))
                                    out[b, c0 + c, y0 + r, xs] = \
                                        acc[c, r].reshape(TW)[:w - x0] / c_
    return outs


def _held(kind, d, shape, vec, span=None):
    b, c, h, w = shape
    rng = np.random.default_rng(d)
    f1, f2 = rng.standard_normal(shape), rng.standard_normal(shape)
    g = rng.standard_normal((b, (2 * d + 1) ** 2, h, w))
    t1, t2, tg = (torch.from_numpy(a) for a in (f1, f2, g))
    if kind == "forward":
        pairs = [(fwd_emulated(f1, f2, d, _config("CV_ANY_FWD"), vec),
                  cv_mod.cost_volume_plain(t1, t2, d))]
    else:
        pairs = zip(bwd_emulated(f1, f2, g, d, _config("CV_ANY_BWD"), vec, span),
                    cv_mod.cost_volume_backward_plain(t1, t2, tg, d))
    for got, want in pairs:
        np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind", ["forward", "backward"])
@pytest.mark.parametrize("d", [11, 12, 16, 20])
def test_general_kernel_index_math_matches_plain(kind, d):
    """The general kernels' decomposition on maps shorter than the shift
    window (most taps fall outside), on both staging paths: 2x13x9x44 (the
    vector path) and 1x11x7x45 (the element path), against the plain
    version."""
    for path, shape in PATH_SHAPES.items():
        _held(kind, d, shape, path == "vector")


@pytest.mark.parametrize("span", [1, 2])
def test_general_backward_in_passes_matches_plain(span):
    """Where the ring of every group of shift columns would not fit (here
    forced: 1 and 2 groups a pass of d=16's), the backward sweeps the shift
    rows once per pass with its own ring."""
    assert bwd_span(_config("CV_ANY_BWD"), 16) > 2
    _held("backward", 16, PATH_SHAPES["vector"], True, span)


def test_general_configurations_fit_the_card():
    """Both configuration lines: threads, the forward's shared memory, the
    backward's span (all groups of shift columns in one pass at d 11-20, in
    passes that fit the SM at any larger d: no limit on d)."""
    r_, is_, js, cc_, p_, minb = _config("CV_ANY_FWD")
    nt, cs = r_ * is_ * TW // p_, r_ * TW + (r_ + is_ - 1) * _round4(TW + js + 2)
    # two fp32 buffers of both tiles; bf16's cp.async slots, 8 bytes a vector
    smem = 4 * 2 * cc_ * cs + 8 * -(-cs // 4 // nt) * cc_ * nt
    assert nt <= 1024 and TW % p_ == 0 and p_ % 4 == 0
    assert minb * (smem + 1024) <= 233472, smem
    cfg = _config("CV_ANY_BWD")
    r_, cb, ch_, js, p_, minb = cfg
    assert TW // p_ * r_ * cb // ch_ <= 1024 and js % 4 == 0
    for d in (11, 12, 16, 20):
        assert bwd_span(cfg, d) == -(-(2 * d + 1) // js), d
    for d in (40, 100, 800):
        span = bwd_span(cfg, d)
        assert 1 <= span < -(-(2 * d + 1) // js) and bwd_smem(cfg, span) <= MAX_SMEM, d
