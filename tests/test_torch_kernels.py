"""The port's kernel wrappers (ocflow_torch.kernels) == the JAX Pallas kernels.

On the CPU the wrappers run their plain versions; the Pallas kernels run in
interpret mode. Same inputs from numpy seeds, fp32. Conv tolerance 1e-4
absolute (O(1)-O(10) values, summation order only), as in
tests/test_pwc_fast.py. The CUDA kernels themselves are held against their
plain versions in tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ocflow_torch.kernels import conv_chain, cost_volume as cv_mod
from ocflow_torch.kernels.conv_chain import ConvSpec, conv_group, prepare_group
from ocflow_torch.models.pwc_fast import _phase_conv_weights, _unpack_phases
from ocflow_torch.ops.cost_volume import cost_volume as plain_cost_volume
from ocflow_tpu.models.pwc_fast import _deconv as j_deconv
from ocflow_tpu.models.pwc_fast import _phase_conv_weights as j_phase_conv_weights
from ocflow_tpu.models.torch_convert import _deconv_kernel
from ocflow_tpu.ops.pallas import conv_chain_kernel as jcc
from ocflow_tpu.ops.pallas.cost_volume_kernel import _forward_pallas
from test_torch_ops import share_cores  # noqa: F401  (autouse)

ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _oihw(w_hwio):
    return _t(np.asarray(w_hwio).transpose(3, 2, 0, 1))


def _flat(x_nchw):
    """NCHW numpy -> the JAX kernel's flat [B, ceil16(C), H*W]."""
    b, c, h, w = x_nchw.shape
    return jcc.nhwc_to_flat(jnp.asarray(x_nchw.transpose(0, 2, 3, 1)))


def _unflat(y, c, h, w):
    return np.asarray(y)[:, :c].reshape(y.shape[0], c, h, w)


def _group(weights_hwio, biases, specs, n_inputs):
    """Port group from the JAX-style per-read HWIO weights."""
    ws = [torch.cat([_oihw(w) for w in per_read], 1) for per_read in weights_hwio]
    return prepare_group(ws, [_t(b) for b in biases], specs, n_inputs,
                         torch.float32, "cpu")


def _jax_specs(specs):
    return [jcc.ConvSpec(reads=s.reads, cout=s.cout, dilation=s.dilation,
                         act=s.act, emit=s.emit) for s in specs]


def test_cost_volume_matches_pallas_and_plain():
    rng = np.random.default_rng(0)
    b, h, w, c, d = 2, 8, 16, 32, 4
    f1 = rng.normal(size=(b, h, w, c)).astype(np.float32)
    f2 = rng.normal(size=(b, h, w, c)).astype(np.float32)
    ref = np.asarray(_forward_pallas(jnp.asarray(f1), jnp.asarray(f2), d,
                                     interpret=True, transpose_out=False))
    t1, t2 = (_t(a.transpose(0, 3, 1, 2)) for a in (f1, f2))
    got = cv_mod.cost_volume(t1, t2, d)
    assert got.shape == (b, (2 * d + 1) ** 2, h, w)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    np.testing.assert_array_equal(got.numpy(),
                                  plain_cost_volume(t1, t2, d).numpy())


def _dense_chain_case(rng):
    """tests/test_pwc_fast.py:27 — a dense multi-read chain, then a d=4
    dilated conv reading the first block."""
    b, h, w, c0 = 2, 8, 128, 20
    x = rng.normal(size=(b, c0, h, w)).astype(np.float32)
    w1 = rng.normal(size=(3, 3, c0, 24)) * 0.1
    w2a = rng.normal(size=(3, 3, c0, 16)) * 0.1
    w2b = rng.normal(size=(3, 3, 24, 16)) * 0.1
    wd = rng.normal(size=(3, 3, 24, 32)) * 0.1
    biases = [rng.normal(size=(n,)) for n in (24, 16, 32)]
    specs = [ConvSpec((0,), 24, emit=True), ConvSpec((0, 1), 16, emit=True),
             ConvSpec((1,), 32, dilation=4, emit=True)]
    return [x], [[w1], [w2a, w2b], [wd]], biases, specs, (h, w)


def _noncontiguous_case(rng):
    """Two inputs; reads out of block order and skipping blocks."""
    b, h, w = 2, 8, 128
    x = rng.normal(size=(b, 16, h, w)).astype(np.float32)
    z = rng.normal(size=(b, 16, h, w)).astype(np.float32)
    specs = [ConvSpec((1,), 16), ConvSpec((2, 0), 16, emit=True),
             ConvSpec((3, 1, 2), 16, act=False, emit=True)]
    weights = [[rng.normal(size=(3, 3, 16, 16)) * 0.1 for _ in s.reads]
               for s in specs]
    biases = [rng.normal(size=(16,)) for _ in specs]
    return [x, z], weights, biases, specs, (h, w)


def _phase_case(rng):
    """A flow head (cout 2) read by an up-flow phase conv (cout 8), the
    fused decoder's tail."""
    b, h, w, c0 = 2, 8, 128, 16
    x = rng.normal(size=(b, c0, h, w)).astype(np.float32)
    deconv = torch.nn.ConvTranspose2d(2, 2, 4, 2, 1)
    with torch.no_grad():
        deconv.weight.copy_(_t(rng.normal(size=(2, 2, 4, 4)) * 0.3))
        deconv.bias.copy_(_t(rng.normal(size=(2,))))
    pw, pb = _phase_conv_weights(deconv)
    specs = [ConvSpec((0,), 16), ConvSpec((0, 1), 2, act=False, emit=True),
             ConvSpec((2,), 8, act=False, emit=True)]
    weights = [[rng.normal(size=(3, 3, c0, 16)) * 0.1],
               [rng.normal(size=(3, 3, c0, 2)) * 0.1,
                rng.normal(size=(3, 3, 16, 2)) * 0.1],
               [pw.numpy().transpose(2, 3, 1, 0)]]
    biases = [rng.normal(size=(16,)), rng.normal(size=(2,)), pb.numpy()]
    return [x], weights, biases, specs, (h, w)


@pytest.mark.parametrize("case", [_dense_chain_case, _noncontiguous_case,
                                  _phase_case])
def test_conv_group_matches_pallas(case):
    rng = np.random.default_rng(1)
    inputs, weights, biases, specs, (h, w) = case(rng)
    got = conv_group([_t(x) for x in inputs],
                     _group(weights, biases, specs, len(inputs)))
    ref = jcc.conv_group(
        [_flat(x) for x in inputs],
        [[jnp.asarray(a, jnp.float32) for a in per] for per in weights],
        [jnp.asarray(b, jnp.float32) for b in biases], _jax_specs(specs),
        h, w, th=8, interpret=True)
    emitted = [s for s in specs if s.emit]
    assert len(got) == len(ref) == len(emitted)
    for g, r, s in zip(got, ref, emitted):
        np.testing.assert_allclose(g.numpy(), _unflat(r, s.cout, h, w),
                                   atol=ATOL)


def test_conv_group_stride2_chain_matches_pallas():
    """tests/test_pwc_fast.py:163 — a stride-2 conv chained into a pair.
    The JAX kernel reads the W-pair packed image; the port reads it as is."""
    rng = np.random.default_rng(2)
    b, h2, w2, c0 = 2, 16, 256, 3
    h, w = h2 // 2, w2 // 2
    img = rng.normal(size=(b, h2, w2, c0)).astype(np.float32)
    weights = [[rng.normal(size=(3, 3, c0, 16)) * 0.1],
               [rng.normal(size=(3, 3, 16, 16)) * 0.1],
               [rng.normal(size=(3, 3, 16, 16)) * 0.1]]
    biases = [rng.normal(size=(16,)) for _ in range(3)]
    specs = [ConvSpec((0,), 16, stride=2, emit=True), ConvSpec((1,), 16),
             ConvSpec((2,), 16, emit=True)]
    got = conv_group([_t(img.transpose(0, 3, 1, 2))],
                     _group(weights, biases, specs, 1))
    jspecs = [jcc.ConvSpec(reads=s.reads, cout=s.cout, emit=s.emit,
                           stride=s.stride, im2col=True) for s in specs]
    xf = jcc.nhwc_to_flat(jnp.asarray(img).reshape(b, h2, w, 2 * c0))
    ref = jcc.conv_group(
        [xf], [[jnp.asarray(a, jnp.float32) for a in per] for per in weights],
        [jnp.asarray(x, jnp.float32) for x in biases], jspecs, h, w, th=4,
        in_strides=(2,), interpret=True)
    for g, r in zip(got, ref):
        assert g.shape == (b, 16, h, w)
        np.testing.assert_allclose(g.numpy(), _unflat(r, 16, h, w), atol=ATOL)


def test_phase_conv_equals_conv_transpose():
    """_phase_conv_weights + _unpack_phases == ConvTranspose2d(4, 2, 1) ==
    the JAX ``_deconv``; the phase weights equal the JAX ones."""
    rng = np.random.default_rng(3)
    cin = 5
    deconv = torch.nn.ConvTranspose2d(cin, 2, 4, 2, 1)
    with torch.no_grad():
        deconv.weight.copy_(_t(rng.normal(size=(cin, 2, 4, 4))))
        deconv.bias.copy_(_t(rng.normal(size=(2,))))
    x = _t(rng.normal(size=(2, cin, 6, 9)))
    pw, pb = _phase_conv_weights(deconv)
    got = _unpack_phases(F.conv2d(x, pw, pb, padding=1))
    with torch.no_grad():
        ref_t = deconv(x)
    np.testing.assert_allclose(got.numpy(), ref_t.numpy(), atol=1e-5)

    flax = {"ConvTranspose_0": {
        "kernel": jnp.asarray(_deconv_kernel(deconv.weight)),
        "bias": jnp.asarray(deconv.bias.detach().numpy())}}
    ref_j = np.asarray(j_deconv(jnp.asarray(x.numpy().transpose(0, 2, 3, 1)),
                                flax))
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), ref_j,
                               atol=1e-5)
    k3, b8 = j_phase_conv_weights(flax)
    np.testing.assert_array_equal(pw.numpy().transpose(2, 3, 1, 0),
                                  np.asarray(k3))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(b8))


def test_cpu_tensors_never_launch():
    """CPU tensors take the plain versions: the launch counters stay put."""
    before = (cv_mod.cost_volume.launches, conv_chain.conv_group.launches)
    rng = np.random.default_rng(4)
    f = _t(rng.normal(size=(1, 4, 5, 6)))
    cv_mod.cost_volume(f, f, 4)
    grp = prepare_group([_t(rng.normal(size=(3, 4, 3, 3)))], [torch.zeros(3)],
                        [ConvSpec((0,), 3, emit=True)], 1, torch.float32, "cpu")
    conv_group([f], grp)
    assert (cv_mod.cost_volume.launches,
            conv_chain.conv_group.launches) == before == (0, 0)


def test_conv_group_rejects_bad_inputs():
    grp = prepare_group([torch.zeros(3, 4, 3, 3)], [torch.zeros(3)],
                        [ConvSpec((0,), 3, emit=True)], 1, torch.float32, "cpu")
    with pytest.raises(ValueError):
        conv_group([torch.zeros(1, 5, 4, 4)], grp)  # 5 channels, weight wants 4
    with pytest.raises(ValueError):
        conv_group([torch.zeros(1, 4, 4, 4, dtype=torch.bfloat16)], grp)
