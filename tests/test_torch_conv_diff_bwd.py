"""B3's backward on the CPU: ``conv_group_diff``'s gradient chain (the plain
versions of the two kernels it runs on the card) and its retained VJP
route, against ``jax.grad`` through the JAX ``conv_group_diff`` (its Pallas
forward in interpret mode, its XLA adjoint); the adjoint weight packing
and the dW kernel's split plan as pure functions.

The group is decoder-shaped, at 2x8x64 (the JAX kernel runs it
lane-packed, two images to a 128-lane row, as tests/test_pwc_fast.py:277
does): four inputs of 17, 8, 2 and 2 channels, growth (16, 16, 8, 8, 4),
a 2-channel head without LeakyReLU, and one more conv over the inputs and
the growth blocks, as level 2's context conv 1; three outputs get no
cotangent and one input needs no gradient.

Tolerances, of each gradient tensor's max |JAX|: fp32 1e-5 (the two sum
the same products in another order); bf16 2^-6, two bf16 ulps of the
largest value: the port sums each cotangent in fp32 and rounds once, the
JAX adjoint adds bf16 partial sums, and both round every stored block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocflow_torch.kernels import conv_chain
from ocflow_torch.kernels.conv_chain import (H100_SMS, TMA_CHUNK, ConvSpec,
                                             adjoint_packed, block_readers, conv_group_diff,
                                             dw_chunks, dw_cout_tile, dw_split, input_runs,
                                             pack_tma_weights, prepare_group, tma_cout_row,
                                             tma_cout_tile)
from ocflow_tpu.ops.pallas.conv_chain_kernel import ConvSpec as JSpec
from ocflow_tpu.ops.pallas.conv_chain_kernel import conv_group_diff as j_conv_group_diff
from test_torch_ops import share_cores  # noqa: F401  (autouse)

B, H, W = 2, 8, 64
IN_CH = (17, 8, 2, 2)
GROWTH = (16, 16, 8, 8, 4)
N_IN = len(IN_CH)
SPECS = ([ConvSpec(tuple(range(N_IN + j)), g) for j, g in enumerate(GROWTH)]
         + [ConvSpec(tuple(range(N_IN + len(GROWTH))), 2, act=False),
            ConvSpec(tuple(range(N_IN + len(GROWTH))), 8)])
CHANS = [*IN_CH, *(s.cout for s in SPECS)]
NO_COTANGENT = (0, 2, 3)   # growth convs whose outputs the loss does not read
NO_GRAD_INPUT = 2          # the first 2-channel input
TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}


def _case(seed=0):
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=(B, H, W, c)).astype(np.float32) for c in IN_CH]
    ws = [[(rng.normal(size=(3, 3, CHANS[r], s.cout)) / np.sqrt(9 * sum(CHANS[q] for q in s.reads))
            ).astype(np.float32) for r in s.reads] for s in SPECS]
    bs = [(rng.normal(size=(s.cout,)) * 0.1).astype(np.float32) for s in SPECS]
    seeds = [None if j in NO_COTANGENT else rng.normal(size=(B, H, W, s.cout)).astype(np.float32)
             for j, s in enumerate(SPECS)]
    return xs, ws, bs, seeds


def _jax_grads(dtype):
    """Gradients of sum(out_j * seed_j) through the JAX group, NCHW / OIHW."""
    xs, ws, bs, seeds = _case()
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jspecs = tuple(JSpec(reads=s.reads, cout=s.cout, act=s.act, emit=True) for s in SPECS)

    def loss(xx, ww, bb):
        outs = j_conv_group_diff(xx, ww, bb, jspecs, H, 128, H, W, True)
        return sum(jnp.sum(o.astype(jnp.float32) * sd) for o, sd in zip(outs, seeds)
                   if sd is not None)

    cast = lambda a: jnp.asarray(a, jd)  # noqa: E731
    gx, gw, gb = jax.grad(loss, argnums=(0, 1, 2))(
        [cast(x) for x in xs], [[cast(w) for w in wj] for wj in ws], [cast(b) for b in bs])
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    return ([f32(g).transpose(0, 3, 1, 2) for g in gx],
            [np.concatenate([f32(g) for g in gj], 2).transpose(3, 2, 0, 1) for gj in gw],
            [f32(g) for g in gb])


def _port_grads(dtype, vjp):
    xs, ws, bs, seeds = _case()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dtype)  # noqa: E731
    xin = [t(x.transpose(0, 3, 1, 2)).requires_grad_(r != NO_GRAD_INPUT)
           for r, x in enumerate(xs)]
    win = [t(np.concatenate(wj, 2).transpose(3, 2, 0, 1)).requires_grad_() for wj in ws]
    bin_ = [t(b).requires_grad_() for b in bs]
    outs = conv_group_diff(xin, win, bin_, SPECS, vjp=vjp)
    loss = sum((o.float() * torch.from_numpy(sd.transpose(0, 3, 1, 2))).sum()
               for o, sd in zip(outs, seeds) if sd is not None)
    loss.backward()
    return xin, win, bin_


@pytest.fixture(scope="module")
def jax_grads():
    return {dtype: _jax_grads(dtype) for dtype in (torch.float32, torch.bfloat16)}


def _hold(got, want, dtype, what):
    err = np.abs(got.detach().float().numpy() - want).max()
    scale = np.abs(want).max()
    assert err <= TOL[dtype] * scale, (what, err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("vjp", [False, True], ids=["chain", "vjp_route"])
def test_conv_group_diff_grads_match_jax(jax_grads, dtype, vjp):
    """Every gradient of the port's backward (the gradient chain on the
    kernels' plain versions, or the VJP route asked for explicitly) against
    JAX's, on the decoder-shaped group; the input that needs no gradient
    gets none."""
    conv_chain.conv_group_diff.vjp_calls = 0
    xin, win, bin_ = _port_grads(dtype, vjp)
    gx, gw, gb = jax_grads[dtype]
    for r, x in enumerate(xin):
        if r == NO_GRAD_INPUT:
            assert x.grad is None
        else:
            assert x.grad.dtype == dtype
            _hold(x.grad, gx[r], dtype, f"input {r}")
    for j, (w, b) in enumerate(zip(win, bin_)):
        assert w.grad.dtype == dtype and b.grad.dtype == dtype
        _hold(w.grad, gw[j], dtype, f"weight {j}")
        _hold(b.grad, gb[j], dtype, f"bias {j}")
    # the VJP route makes one conv VJP per (conv, read block); the chain none
    assert conv_chain.conv_group_diff.vjp_calls == (
        sum(len(s.reads) for s in SPECS) if vjp else 0)


def test_backward_routes():
    """CPU groups of stride-1 convs take the gradient chain on the plain
    versions; a stride-2 spec anywhere takes the VJP route."""
    x = torch.zeros(1, 4, 8, 16)
    assert conv_chain.backward_route([x], SPECS[:1], torch.float32) == "plain"
    assert conv_chain.backward_route([x], SPECS[:1], torch.bfloat16) == "plain"
    s2 = [ConvSpec((0,), 8, stride=2), ConvSpec((1,), 8)]
    assert conv_chain.backward_route([x], s2, torch.bfloat16) == "vjp"


def test_block_readers_and_input_runs():
    """Each read of a block with its channel offset in the reader's
    weight; the main path's inputs make one run, which breaks where a conv
    reads the inputs apart, out of order or not all of them."""
    assert block_readers(SPECS, CHANS, 1) == [(j, IN_CH[0]) for j in range(len(SPECS))]
    head = len(SPECS) - 2
    assert block_readers(SPECS, CHANS, N_IN + head) == []
    off = sum(CHANS[:N_IN + 4])
    assert block_readers(SPECS, CHANS, N_IN + 4) == [(head, off), (head + 1, off)]
    assert input_runs(SPECS, CHANS, [True] * 4) == [(0, 1, 2, 3)]
    assert input_runs(SPECS, CHANS, [True, True, False, True]) == [(0, 1), (3,)]
    apart = [ConvSpec((0, 2, 1), 4), ConvSpec((0, 1, 2, 3), 4)]
    assert input_runs(apart, [3, 3, 3, 4, 4], [True] * 3) == [(0,), (1,), (2,)]
    some = [ConvSpec((0,), 4), ConvSpec((0, 1), 4)]
    assert input_runs(some, [3, 3, 4, 4], [True] * 2) == [(0,), (1,)]
    twice = [ConvSpec((0, 1, 0), 4)]
    assert input_runs(twice, [3, 3, 4], [True] * 2) == [(0,), (1,)]


def _unpack_tma(t, chans, cout):
    """The TMA kernel's weight rows back to ``[9, sum(padded chans), ntn nt]``."""
    nt, ntn = tma_cout_tile(cout)
    nchunk = sum(-(-c // TMA_CHUNK) for c in chans)
    w = t.view(ntn, nchunk, 9, TMA_CHUNK, tma_cout_row(nt))[..., :nt]
    return w.permute(2, 1, 3, 0, 4).reshape(9, nchunk * TMA_CHUNK, ntn * nt)


@pytest.mark.parametrize("bid", [0, N_IN, N_IN + 3, N_IN + 4], ids=["input", "g0", "g3", "g4"])
def test_adjoint_packing_is_the_flipped_transposed_weight(bid):
    """A block's adjoint weights, from the forward's packing, are each
    reader's weight over the block's channels with the window flipped and
    in and out channels swapped; the TMA packing of them for the readers'
    merged segments unpacks to that, zero past each segment (its last
    16-channel chunk) and past the block's channels."""
    rng = np.random.default_rng(3)
    ws = [torch.from_numpy(rng.normal(size=(s.cout, sum(CHANS[r] for r in s.reads), 3, 3))
                           ).float() for s in SPECS]
    group = prepare_group(ws, [torch.zeros(s.cout) for s in SPECS], SPECS, N_IN,
                          torch.float32, "cpu")
    readers = block_readers(SPECS, CHANS, bid)
    cb = CHANS[bid]
    packed = adjoint_packed(group.packed, SPECS, cb, readers)
    want = torch.cat([ws[k][:, off:off + cb].flip(2, 3).transpose(0, 1) for k, off in readers], 1)
    assert torch.equal(packed.view(3, 3, -1, cb).permute(3, 2, 0, 1), want)

    ks = [k for k, _ in readers]
    segs = conv_chain.reader_chans(SPECS, ks)
    assert sum(segs) == want.shape[1]
    got = _unpack_tma(pack_tma_weights(packed, segs, cb), segs, cb)
    ref = want.permute(2, 3, 1, 0).reshape(9, -1, cb)  # [tap, reader cout, block channel]
    pos = 0
    for seg_start, c in zip(np.cumsum([0, *segs[:-1]]), segs):
        pad = -(-c // TMA_CHUNK) * TMA_CHUNK
        assert torch.equal(got[:, pos:pos + c, :cb], ref[:, seg_start:seg_start + c])
        assert not got[:, pos + c:pos + pad].any()
        pos += pad
    assert not got[:, :, cb:].any()


def test_reader_segments_merge_consecutive_convs():
    assert conv_chain.reader_chans(SPECS, [1, 2, 3, 5]) == (16 + 8 + 8, 2)
    assert conv_chain.reader_chans(SPECS, [0, 0]) == (16, 16)


@pytest.mark.parametrize("b,h,w", [(8, 7, 16), (8, 14, 32), (8, 28, 64), (8, 56, 128),
                                   (8, 112, 256), (1, 3, 24), (8, 40, 152)])
def test_dw_split_fills_one_wave_of_132_sms(b, h, w):
    """The dW kernel's split: every unit has a K step, one wave of the
    H100's 132 SMs holds every block, and a unit more would not fit (or
    every K step already has its own block); split 1 where the chunk x cout
    tile units fill the card alone."""
    ksteps = b * h * -(-w // 64)
    for cin in (2, 81, 117, 213, 565, 1200):
        for cout in (2, 16, 32, 64, 96, 128, 200):
            nchunk = len(dw_chunks([cin] if cin <= 565 else [565, cin - 565]))
            nw, ntn = dw_cout_tile(cout)
            assert cout <= 2 * nw * ntn and (nw == 32 or cout <= 2 * nw)
            mn = nchunk * ntn
            split = dw_split(b, h, w, nchunk, ntn)
            assert 1 <= split <= ksteps
            if mn >= H100_SMS:
                assert split == 1
            else:
                assert mn * split <= H100_SMS
                assert split == ksteps or mn * (split + 1) > H100_SMS


def test_dw_chunks_and_cout_tiles():
    assert dw_chunks([117, 448]) == [(0, 0), (0, 64), (1, 0), (1, 64), (1, 128), (1, 192),
                                     (1, 256), (1, 320), (1, 384)]
    assert [dw_cout_tile(c) for c in (2, 16, 17, 32, 64, 96, 128)] == [
        (8, 1), (8, 1), (16, 1), (16, 1), (32, 1), (32, 2), (32, 2)]
    with pytest.raises(ValueError):
        dw_chunks([64 * 65])


def test_dw_plain_is_the_conv_weight_gradient():
    """The dW kernel's plain version (per-tap contractions over pixels)
    equals autograd's weight and bias gradient of the conv, fp32, also
    dilated."""
    gen = torch.Generator().manual_seed(5)
    reads = [torch.randn(2, 5, 6, 10, generator=gen), torch.randn(2, 3, 6, 10, generator=gen)]
    g = torch.randn(2, 4, 6, 10, generator=gen)
    for d in (1, 2):
        w = torch.zeros(4, 8, 3, 3, requires_grad=True)
        b = torch.zeros(4, requires_grad=True)
        y = torch.nn.functional.conv2d(torch.cat(reads, 1), w, b, padding=d, dilation=d)
        y.backward(g)
        dw, db = conv_chain.dw_plain(reads, g, torch.float32, torch.float32, d)
        torch.testing.assert_close(dw, w.grad, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(db, b.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_adjoint_plan_gathers_each_blocks_packing(dtype):
    """The forward's one gather through the cached index gives, bit for
    bit, each block's (and input run's) adjoint weights and their TMA
    packing as the per-block packing functions make them from the
    forward's packed weights."""
    rng = np.random.default_rng(7)
    ws = [torch.from_numpy(rng.normal(size=(s.cout, sum(CHANS[r] for r in s.reads), 3, 3))
                           ).float() for s in SPECS]
    group = prepare_group(ws, [torch.zeros(s.cout) for s in SPECS], SPECS, N_IN, dtype, "cpu")
    plan = conv_chain.adjoint_plan(group, CHANS, (True, False, True, True), kernel=True)
    assert set(plan) == {N_IN + j for j in range(len(GROWTH))} | {(0,), (2, 3)}
    for key, parts in plan.items():
        ids = (key,) if isinstance(key, int) else key
        cb = sum(CHANS[b] for b in ids)
        ((ks, d, packed, tma),) = parts
        ref = adjoint_packed(group.packed, SPECS, cb, block_readers(SPECS, CHANS, ids[0]))
        segs = conv_chain.reader_chans(SPECS, ks)
        assert d == 1 and packed.dtype == dtype and torch.equal(packed, ref)
        assert list(tma) == [segs] and torch.equal(tma[segs], pack_tma_weights(ref, segs, cb))


def test_chain_plan_packs_only_what_the_backward_reads():
    """The forward packs the adjoint of every stripe block that a conv
    reads and of each run of the inputs that want a gradient (on the CPU
    without the TMA kernel's packing)."""
    xs, ws, bs, _ = _case()
    group = prepare_group([torch.from_numpy(np.concatenate(wj, 2).transpose(3, 2, 0, 1).copy())
                           for wj in ws], [torch.from_numpy(b) for b in bs], SPECS, N_IN,
                          torch.float32, "cpu")
    need = [True, True, False, True]
    plan = conv_chain.adjoint_plan(group, CHANS, need, kernel=False)
    head = len(SPECS) - 2
    assert set(plan) == ({N_IN + j for j in range(len(SPECS))} - {N_IN + head, N_IN + head + 1}
                         ) | {(0, 1), (3,)}
    for parts in plan.values():
        assert len(parts) == 1 and parts[0][1] == 1 and parts[0][3] == {}


@pytest.mark.parametrize("q8", [False, True], ids=["bf16", "int8"])
def test_tma_ablation_removals_still_apply(q8):
    """The TMA kernels' ablation variants (``tools/conv_tma_ablation.py``
    ``--remove``) find the code they take out once in each source: the
    bf16 kernel's shift now calls the helper it shares with the dW kernel
    (``csrc/hopper.cuh:shift_lines``)."""
    from ocflow_torch.tools import conv_tma_ablation

    for part in conv_tma_ablation.REMOVALS_Q8 if q8 else conv_tma_ablation.REMOVALS:
        text = conv_tma_ablation._removed(part, q8)
        assert "if (0)" in text or "if (false)" in text or "if (true)" in text
