"""The port's W8A8 serving path (``kernels.conv_chain_q8``, ``calibrate_q8``,
``fast_apply(q8=...)``) and its GEMM probe == the JAX package.

Same inputs from numpy seeds, fp32 on the CPU; the JAX ``conv_group_q8``
runs in interpret mode, its plain functions as they are. On the CPU the
port's wrappers run their plain versions (exact integer convs in float64,
the same fp32 epilogue). Tolerances are those of tests/test_pwc_fast.py:
int8 codes within 1 on fewer than 1e-3 of the elements (a .5 boundary met
through another fp32 rounding), bf16 outputs within 8e-3 of max|ref|.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocflow_torch.kernels import conv_chain_q8 as q8mod
from ocflow_torch.kernels import gemm as gemm_mod
from ocflow_torch.kernels.conv_chain import ConvSpec
from ocflow_torch.kernels.conv_chain_q8 import (conv_group_q8, fold_quant_weights,
                                                prepare_group_q8, quantize_q8)
from ocflow_torch.models import (FlowNetCV, calibrate_q8, fast_apply,
                                 flownetcv_from_flax, prepare, q8_scales_from_numpy)
from ocflow_torch.models.pwc_fast import _decoder, _run
from ocflow_tpu.models import pwc_fast as jpf
from ocflow_tpu.models import pwc_net as jpwc
from ocflow_tpu.models.torch_convert import convert_flownetcv
from ocflow_tpu.ops.pallas import conv_chain_kernel as jcc
from test_torch_ops import share_cores  # noqa: F401  (autouse)

BF16_REL = 8e-3
CODE_FRAC = 1e-3
# fast_apply(q8) vs the exact JAX forward, quarter-flow max-abs relative to
# max|flow_quarter|, keyed by "encoder and context chain int8 too": the JAX
# package's own bounds for the same two modes, on its tests' own weights and
# input (tests/test_pwc_fast.py:546 and :673).
Q8_E2E_BOUND = {False: 0.05, True: 0.1}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _oihw(w_hwio):
    return _t(np.asarray(w_hwio).transpose(3, 2, 0, 1))


def _flat(x_nchw, c_pad=None):
    """NCHW numpy -> the JAX kernels' flat [B, C (zero-padded), H*W]."""
    b, c, h, w = x_nchw.shape
    c_pad = c_pad or -(-c // 16) * 16
    x = np.pad(x_nchw, ((0, 0), (0, c_pad - c), (0, 0), (0, 0)))
    return jnp.asarray(x.reshape(b, c_pad, h * w))


def _unflat(y, c, h, w):
    return np.asarray(y.astype(jnp.float32))[:, :c].reshape(y.shape[0], c, h, w)


def _codes_close(got, ref):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(ref, np.int32))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() < CODE_FRAC, (d > 0).mean()


def _bf16_close(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert np.abs(got - ref).max() <= BF16_REL * np.abs(ref).max(), (
        np.abs(got - ref).max(), np.abs(ref).max())


def test_quantize_and_fold_equal_jax():
    """Codes and fp32 weight scales are equal, including an all-zero output
    channel and an all-zero weight (the 1e-30 scale floor)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 5, 9)).astype(np.float32) * 3
    s = np.float32(np.abs(x).max() / 127.0)
    x.flat[:40] = (np.arange(40) - 20 + 0.5) * s  # near .5 boundaries
    np.testing.assert_array_equal(
        quantize_q8(_t(x), s).numpy(),
        np.asarray(jcc.quantize_q8(jnp.asarray(x), s)))

    wa = rng.normal(size=(3, 3, 20, 12)).astype(np.float32) * 0.1
    wb = rng.normal(size=(3, 3, 8, 12)).astype(np.float32)
    wa[..., 3] = 0.0
    wb[..., 3] = 0.0
    scales = [np.float32(0.021), np.float32(0.37)]
    for ws in ([wa, wb], [np.zeros_like(wb)]):
        sc = scales[:len(ws)]
        wq, wscale = fold_quant_weights([_oihw(w) for w in ws], sc)
        jq, jscale = jcc.fold_quant_weights([jnp.asarray(w) for w in ws], sc, 12)
        np.testing.assert_array_equal(wq.numpy().transpose(2, 3, 1, 0),
                                      np.asarray(jq))
        np.testing.assert_array_equal(wscale.numpy(), np.asarray(jscale))


def _dense_case(rng):
    """tests/test_pwc_fast.py:473 — an int8 conv, then a two-read conv
    emitting bf16."""
    b, h, w, c0 = 2, 16, 128, 32
    x = rng.normal(size=(b, c0, h, w)).astype(np.float32)
    weights = [[rng.normal(size=(3, 3, c0, 32)) * 0.1],
               [rng.normal(size=(3, 3, c0, 24)) * 0.1,
                rng.normal(size=(3, 3, 32, 24)) * 0.1]]
    biases = [rng.normal(size=(32,)), rng.normal(size=(24,))]
    specs = [ConvSpec((0,), 32, q8=True), ConvSpec((0, 1), 24, emit=True)]
    s_in = np.float32(np.abs(x).max() / 127.0)
    return x, weights, biases, specs, s_in, [np.float32(0.05), None], 8, 1


def _stride2_case(rng):
    """tests/test_pwc_fast.py:549 — a stride-2 conv and a pair, emitting
    int8 codes (the W8A8 encoder level)."""
    b, h2, w2, cin, c = 2, 16, 256, 6, 16
    x = rng.uniform(-1, 1, (b, cin, h2, w2)).astype(np.float32)
    weights = [[rng.normal(size=(3, 3, cin, c)) * 0.2],
               [rng.normal(size=(3, 3, c, c)) * 0.2]]
    biases = [rng.normal(size=(c,)) * 0.1, rng.normal(size=(c,)) * 0.1]
    specs = [ConvSpec((0,), c, stride=2, q8=True),
             ConvSpec((1,), c, q8=True, emit=True)]
    return (x, weights, biases, specs, np.float32(1.0 / 127.0),
            [np.float32(0.02), np.float32(0.02)], 4, 2)


def _dilated_case(rng):
    """tests/test_pwc_fast.py:607 — a dilated int8 chain (the W8A8 context
    chain), the last conv emitting bf16 without activation."""
    b, h, w, c0 = 2, 16, 128, 32
    x = rng.normal(size=(b, c0, h, w)).astype(np.float32)
    weights = [[rng.normal(size=(3, 3, c0, 32)) * 0.1],
               [rng.normal(size=(3, 3, 32, 8)) * 0.1]]
    biases = [rng.normal(size=(32,)), rng.normal(size=(8,))]
    specs = [ConvSpec((0,), 32, dilation=2, q8=True),
             ConvSpec((1,), 8, dilation=4, act=False, emit=True)]
    s_in = np.float32(np.abs(x).max() / 127.0)
    return x, weights, biases, specs, s_in, [np.float32(0.05), None], 16, 1


@pytest.mark.parametrize("case", [_dense_case, _stride2_case, _dilated_case])
def test_conv_group_q8_matches_pallas(case):
    """The port's group (plain version) == JAX conv_group_q8(interpret=True).
    Measured: stride-2 codes all equal; bf16 outputs differ in 1 of 98304
    (dense, 6.6e-7 of max|ref|) and 2 of 32768 elements (dilated, 2.5e-5):
    a bf16 rounding step of an epilogue value."""
    rng = np.random.default_rng(3)
    x, weights, biases, specs, s_in, scales, th, in_stride = case(rng)
    b, c0, hi, wi = x.shape
    h, w = hi // in_stride, wi // in_stride
    group = prepare_group_q8(
        [torch.cat([_oihw(a) for a in per], 1) for per in weights],
        [_t(bb) for bb in biases], specs, (c0,), s_in, scales, "cpu")
    (got,) = conv_group_q8([quantize_q8(_t(x), s_in)], group)

    codes = jcc.quantize_q8(jnp.asarray(x.transpose(0, 2, 3, 1)), s_in)
    if in_stride == 2:  # the TPU kernel reads the W-pair packed image
        cp = -(-2 * c0 // 32) * 32
        xq = jcc.nhwc_to_flat(codes.reshape(b, hi, w, 2 * c0), c_pad=cp)
    else:
        xq = jcc.nhwc_to_flat(codes)
    jspecs = [jcc.ConvSpec(reads=s.reads, cout=s.cout, dilation=s.dilation,
                           act=s.act, emit=s.emit, q8=s.q8, stride=s.stride,
                           im2col=in_stride == 2) for s in specs]
    (ref,) = jcc.conv_group_q8(
        xq, s_in, [[jnp.asarray(a, jnp.float32) for a in per] for per in weights],
        [jnp.asarray(bb, jnp.float32) for bb in biases], jspecs, scales, h, w,
        th=th, interpret=True, in_stride=in_stride)
    last = specs[-1]
    assert got.shape == (b, last.cout, h, w)
    if last.q8:
        assert got.dtype == torch.int8
        _codes_close(got.numpy(), _unflat(ref, last.cout, h, w))
    else:
        assert got.dtype == torch.bfloat16
        _bf16_close(got.float().numpy(), _unflat(ref, last.cout, h, w))


def _net(seed):
    model = FlowNetCV(generator=torch.Generator().manual_seed(seed))
    return model, convert_flownetcv(model.state_dict())["params"]


def _growth_scales(dec, xin):
    """{'in', 'growth'} of one decoder on its input, as calibrate_q8 does."""
    sc = {"in": q8mod.amax_scale(xin), "growth": []}
    with torch.no_grad():
        for j in range(5):
            c = getattr(dec, f"conv{dec.level}_{j}")(xin)
            sc["growth"].append(q8mod.amax_scale(c))
            xin = torch.cat([c, xin], 1)
    return sc


def _decoder_inputs(rng, feat_ch, b=2, h=8, w=128):
    corr = np.maximum(rng.normal(size=(b, 81, h, w)), 0) * 0.5
    c1n = rng.normal(size=(b, feat_ch, h, w))
    up = rng.normal(size=(b, 4, h, w)) * 2
    return [a.astype(np.float32) for a in (corr, c1n, up[:, :2], up[:, 2:])]


@pytest.mark.parametrize("level", [3, 2])
def test_decoder_groups_match_pallas(level):
    """A level-3 decoder group (growth int8, flow head in the bf16 side
    stripe read by the up-flow phase conv, up-feat phase conv) and the
    level-2 group (growth int8, flow head and context conv 1 emitting
    bf16), built by the port's ``prepare`` at full channel widths, == JAX
    ``_fused_dense_decoder_q8`` / ``_fused_level2_q8`` in interpret mode
    on the same weights, scales and inputs (B=2, 8x128).
    Measured: level 3 outputs all equal; level 2 flow equal, context conv
    1 differs in 2 of 262144 elements (5.5e-5 of max|ref|)."""
    model, p = _net(11)
    rng = np.random.default_rng(12)
    feat_ch = {3: 64, 2: 32}[level]
    inputs = _decoder_inputs(rng, feat_ch)
    b, _, h, w = inputs[0].shape
    idx = 6 - level  # dec0 = level 6
    dec = model.decoders[idx]
    sc = _growth_scales(dec, torch.cat([_t(a) for a in inputs], 1))
    scales = {f"dec{i}": sc for i in range(5)}
    fw = prepare(model, torch.float32, "cpu", scales)

    xcat = np.concatenate(inputs, 1)
    c0 = xcat.shape[1]
    xf = _flat(xcat)
    jsc = {"in": np.float32(sc["in"]),
           "growth": [np.float32(s) for s in sc["growth"]]}
    if level == 3:
        got = _decoder(fw.decoders[idx], [_t(a) for a in inputs])
        ref = jpf._fused_dense_decoder_q8(
            p[f"DenseDecoder_{idx}"], xf, (b, h, w, c0), jsc,
            p[f"Deconv_{2 * idx + 1}"], p[f"Deconv_{2 * idx}"], 8,
            interpret=True)
        ref = [np.asarray(r.astype(jnp.float32)).transpose(0, 3, 1, 2) for r in ref]
    else:
        got = _run(fw.level2, [_t(a) for a in inputs])
        ref = jpf._fused_level2_q8(
            p["DenseDecoder_4"], p["ContextNetwork_0"], xf, (b, h, w, c0),
            jsc, th=8, interpret=True)
        ref = [_unflat(r, c, h, w) for r, c in zip(ref, (2, 128))]
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        _bf16_close(g.float().numpy(), r)


def _input(seed, b=2, h=64, w=128):
    return np.random.default_rng(seed).uniform(-1, 1, (b, h, w, 6)).astype(np.float32)


@pytest.mark.parametrize("enc_ctx", [False, True])
def test_calibrate_q8_matches_jax(enc_ctx):
    """Every scale within 1e-4 relative of JAX calibrate_q8 (2x64x128 fp32,
    same weights). Measured: at most 8.8e-7 relative."""
    model, p = _net(0)
    x = _input(1)
    got = calibrate_q8(model, _t(x), encoder=enc_ctx, ctx=enc_ctx, device="cpu")
    ref = q8_scales_from_numpy(jax.jit(
        jpf.calibrate_q8, static_argnames=("encoder", "ctx"))(
            {"params": p}, jnp.asarray(x), encoder=enc_ctx, ctx=enc_ctx))
    assert set(got) == set(ref)
    flat_g = jax.tree_util.tree_leaves(got)
    flat_r = jax.tree_util.tree_leaves(ref)
    assert len(flat_g) == len(flat_r) == (30 + 6 + 19 if enc_ctx else 30)
    np.testing.assert_allclose(flat_g, flat_r, rtol=1e-4)


@functools.lru_cache(maxsize=1)
def _reference_setting():
    """The JAX q8 tests' network, weights and input, and the port's model
    on those weights (built once for both modes)."""
    x = np.random.default_rng(4).uniform(-1, 1, (2, 64, 512, 6)).astype(np.float32)
    net = jpwc.FlowNetCV()
    # the parameters depend on the key, not on the input's size
    variables = jax.jit(net.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 6)))
    model = FlowNetCV()
    model.load_state_dict(flownetcv_from_flax(variables["params"]))
    return net, variables, model, x


@pytest.mark.parametrize("enc_ctx", [False, True])
def test_fast_apply_q8_close_to_jax(enc_ctx):
    """The whole W8A8 slice on the CPU, with the JAX package's own scales,
    against JAX FlowNetCV.apply fp32 on the same weights: the setting of
    tests/test_pwc_fast.py:530 and :655 (flax init from PRNGKey(0), input
    uniform from numpy seed 4, 2x64x512). The port runs all five decoders
    int8 (the JAX forward falls back to bf16 on its narrow levels at this
    shape). Measured: 0.032 (decoders) and 0.078 (encoder and context
    chain too) of max|flow_quarter|; flax init keys 1-3 give 0.037-0.054
    and 0.062-0.104, the same spread of quantization noise, while every
    group matches the JAX kernel (the tests above)."""
    net, variables, model, x = _reference_setting()
    scales = jax.jit(jpf.calibrate_q8, static_argnames=("encoder", "ctx"))(
        variables, jnp.asarray(x), encoder=enc_ctx, ctx=enc_ctx)
    _, ref_q = jax.jit(net.apply)(variables, jnp.asarray(x))
    full, quarter = fast_apply(model, _t(x), q8=q8_scales_from_numpy(scales),
                               device="cpu")
    assert full.shape == (2, 64, 512, 2) and quarter.shape == (2, 16, 128, 2)
    ref_q = np.asarray(ref_q)
    err = np.abs(quarter.numpy() - ref_q).max()
    assert err < Q8_E2E_BOUND[enc_ctx] * np.abs(ref_q).max(), (err, np.abs(ref_q).max())


def test_prepare_repacks_for_new_scales():
    """New scale values repack the W8A8 groups (two scale sets, two results);
    the same values reuse the packing."""
    model, _ = _net(2)
    x = _t(_input(3, b=1))
    sc = calibrate_q8(model, x, device="cpu")
    other = jax.tree_util.tree_map(lambda s: s * 1.5, sc)
    a = fast_apply(model, x, q8=sc, device="cpu")
    b = fast_apply(model, x, q8=other, device="cpu")
    assert not np.array_equal(a[1].numpy(), b[1].numpy())
    assert prepare(model, torch.float32, "cpu", dict(sc)) is prepare(
        model, torch.float32, "cpu", sc)
    assert prepare(model, torch.float32, "cpu", other) is not prepare(
        model, torch.float32, "cpu", sc)
    counts = prepare(model, torch.float32, "cpu", sc).launch_counts()
    assert counts == {"conv_group": 24, "conv_group_q8": 35}


def test_cpu_tensors_never_launch_q8_or_gemm():
    before = (q8mod.conv_group_q8.launches, gemm_mod.gemm.launches)
    rng = np.random.default_rng(4)
    grp = prepare_group_q8([_t(rng.normal(size=(3, 4, 3, 3)))], [torch.zeros(3)],
                           [ConvSpec((0,), 3, emit=True, q8=True)], (4,), 0.1,
                           [0.2], "cpu")
    conv_group_q8([quantize_q8(_t(rng.normal(size=(1, 4, 5, 6))), 0.1)], grp)
    a = torch.randint(-127, 128, (128, 32), dtype=torch.int8)
    gemm_mod.gemm(a, a.t().contiguous())
    assert (q8mod.conv_group_q8.launches, gemm_mod.gemm.launches) == before == (0, 0)


def test_gemm_probe_plain():
    """int8 -> int32 exact; bf16 -> fp32 within 1e-2 of max|ref|."""
    rng = np.random.default_rng(5)
    a = rng.integers(-127, 128, (64, 96))
    b = rng.integers(-127, 128, (96, 80))
    got = gemm_mod.gemm(torch.tensor(a, dtype=torch.int8),
                        torch.tensor(b, dtype=torch.int8))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a @ b)
    af = torch.tensor(rng.normal(size=(64, 96))).bfloat16()
    bf = torch.tensor(rng.normal(size=(96, 80))).bfloat16()
    got = gemm_mod.gemm(af, bf)
    ref = af.double().numpy() @ bf.double().numpy()
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() <= 1e-2 * np.abs(ref).max()


def test_bench_q8_calibrates_on_a_held_out_batch():
    """``bench --q8``'s pieces on the CPU at a tiny size: the held-out
    batch differs from the measured one, and the W8A8 timing loop runs."""
    from ocflow_torch import bench

    model, x = bench.make_inputs(1, 64, 64, torch.float32, "cpu", seed=0)
    xc = bench.calibration_batch(x)
    assert xc.shape == x.shape and xc.dtype == x.dtype and not torch.equal(xc, x)
    assert xc.abs().max() <= 1
    scales = calibrate_q8(model, xc, device="cpu")
    res = bench.measure(model, x, scales, iters=1, warmup=0)
    assert res["ms_per_batch"] > 0 and res["pairs_per_sec"] > 0


def test_spike_int8_bound_and_card_requirement():
    """The probe's bound at 2048^3 (int8: operations, 8.7 us; bf16: 17.4
    us) and its operands; without a card it raises instead of timing the
    CPU."""
    from ocflow_torch.tools import spike_int8

    b8, by8 = spike_int8.bound_ms(2048, 2048, 2048, torch.int8)
    b16, by16 = spike_int8.bound_ms(2048, 2048, 2048, torch.bfloat16)
    assert (by8, by16) == ("operations", "operations")
    assert b8 == pytest.approx(2 * 2048 ** 3 / 1979e12 * 1e3)
    assert b16 == pytest.approx(2 * 2048 ** 3 / 989e12 * 1e3)
    a, b = spike_int8.operands(64, torch.int8, "cpu")
    assert a.dtype == torch.int8 and a.abs().max() <= 127 and not torch.equal(a, b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            spike_int8.main()


def test_q8_error_tool_on_cpu():
    """The W8A8 accuracy tool at a tiny size: both modes, both flows,
    finite errors beside a positive flow scale."""
    from ocflow_torch.tools import q8_error

    res = q8_error.q8_errors(1, 64, 64, torch.float32, "cpu")
    assert set(res) == {"w8a8", "w8a8_enc_ctx"}
    for mode in res.values():
        assert set(mode) == {"full", "quarter"}
        for e in mode.values():
            assert e["max_ref"] > 0 and np.isfinite(
                [e["rel_l2"], e["max_abs"], e["max_abs_rel"]]).all()
