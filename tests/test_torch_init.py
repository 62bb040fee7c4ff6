"""The port's seeded init against flax's default initializers (C1), and
its BatchNorm against flax's train-mode BatchNorm.

The init: ``FlowNetCV(generator=seed 0)`` against the JAX package's
``FlowNetCV().init(PRNGKey(0))`` on a 1x64x128x6 input, layer by layer
through ``convert_flownetcv``: std * sqrt(fan_in) (fan-in ``cin * kh * kw``
for convs and transposed convs alike) within 0.05 of flax's for every layer
of at least 1000 weights (the sampling error of a std there is under 2.3%);
the six smaller layers (the four 2->2 4x4 upsamplers, 64 weights, ~9%
sampling error each, flax's own range 0.87-1.04; two convs of 432 and 576
weights) pooled within 0.05 of flax's pooled value and each within four
sampling errors of 1 (a fan-in off by the stride product, 2x, is far
outside); max|w| * sqrt(fan_in) at most 2 / 0.8796 (flax's cut of
its truncated normal at two std); zero biases; BatchNorm at the identity.

The BatchNorm: ``models.common.BatchNorm`` in train mode against
``flax.linen.BatchNorm(momentum=0.9, use_running_average=False)`` with
``mutable=["batch_stats"]``: output and updated statistics within 1e-5
(fp32 summation order), in eval mode the running statistics.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocflow_torch.bench import perturb_batchnorm
from ocflow_torch.models import FlowNetC, FlowNetCV, FlowOccNet, SimpleFlowNet
from ocflow_torch.models.common import TRUNC_STD, BatchNorm, ConvBlock
from ocflow_tpu.models import common as jcommon
from ocflow_tpu.models import pwc_net as jpwc
from ocflow_tpu.models.torch_convert import convert_flownetcv
from test_torch_ops import share_cores  # noqa: F401  (autouse)


def _kernels():
    """[(path, flax kernel, port kernel as flax HWIO)] of FlowNetCV."""
    flax_vars = jpwc.FlowNetCV().init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 128, 6)))
    port = convert_flownetcv(FlowNetCV(generator=torch.Generator().manual_seed(0)).state_dict())
    ours = dict(jax.tree_util.tree_leaves_with_path(port["params"]))
    return [(path, np.asarray(a), np.asarray(ours[path]))
            for path, a in jax.tree_util.tree_leaves_with_path(flax_vars["params"])
            if path[-1].key == "kernel"]


def _scaled_std(k):
    kh, kw, cin, _ = k.shape
    return float(k.std() * np.sqrt(kh * kw * cin))


def test_seeded_draws_match_flax_distribution():
    kernels = _kernels()
    small = []
    n_conv = n_deconv = 0
    for path, ref, got in kernels:
        deconv = "ConvTranspose" in jax.tree_util.keystr(path)
        n_deconv += deconv
        n_conv += not deconv
        if ref.size >= 1000:
            assert abs(_scaled_std(got) - _scaled_std(ref)) <= 0.05, path
        else:
            small.append((ref, got))
            assert abs(_scaled_std(got) - 1.0) <= 4 / np.sqrt(2 * got.size), path
        kh, kw, cin, _ = got.shape
        assert np.abs(got).max() * np.sqrt(kh * kw * cin) <= 2 / TRUNC_STD * (1 + 1e-6), path
    # the four 2->2 upsamplers and two 3x3 convs of 432 and 576 weights
    assert (n_conv, n_deconv, len(small)) == (55, 8, 6)
    pooled = [np.sqrt(np.mean([_scaled_std(k[i]) ** 2 for k in small])) for i in (0, 1)]
    assert abs(pooled[1] - pooled[0]) <= 0.05, pooled


def test_seeded_biases_are_zero_and_batchnorm_the_identity():
    for cls in (FlowNetCV, FlowNetC, FlowOccNet, SimpleFlowNet):
        model = cls(generator=torch.Generator().manual_seed(0))
        for name, t in model.state_dict().items():
            if name.endswith("bias") or name.endswith("running_mean"):
                assert not t.any(), (cls, name)
            elif name.endswith("running_var"):
                assert torch.equal(t, torch.ones_like(t)), (cls, name)
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                assert isinstance(m, BatchNorm) and torch.equal(m.weight, torch.ones_like(m.weight))


def test_seeded_draws_are_deterministic_and_follow_the_seed():
    a = FlowNetC(generator=torch.Generator().manual_seed(4)).state_dict()
    b = FlowNetC(generator=torch.Generator().manual_seed(4)).state_dict()
    c = FlowNetC(generator=torch.Generator().manual_seed(5)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1.0.weight"], c["conv1.0.weight"])


def _flax_bn(x, scale, bias, mean, var, train):
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    bn = nn.BatchNorm(use_running_average=not train, momentum=0.9, epsilon=1e-5)
    if train:
        y, upd = bn.apply(variables, x, mutable=["batch_stats"])
        return np.asarray(y), upd["batch_stats"]
    return np.asarray(bn.apply(variables, x)), variables["batch_stats"]


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("shape", [(2, 12, 16, 24), (2, 5, 1, 3)])
def test_batchnorm_matches_flax(shape, train):
    """Train mode normalizes by the biased batch variance and updates the
    running variance with it (``BatchNorm2d`` would use the unbiased one:
    at 2x1x3 per channel that is 6/5 of it); eval mode reads the running
    statistics."""
    rng = np.random.default_rng(sum(shape))
    b, c, h, w = shape
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, c), rng.uniform(-0.1, 0.1, c)
    mean, var = rng.uniform(-0.1, 0.1, c), rng.uniform(0.5, 2.0, c)
    params = [a.astype(np.float32) for a in (scale, bias, mean, var)]
    ref, stats = _flax_bn(jnp.asarray(x.transpose(0, 2, 3, 1)), *params, train)
    bn = BatchNorm(c)
    for t, a in zip((bn.weight, bn.bias, bn.running_mean, bn.running_var), params):
        t.data.copy_(torch.from_numpy(a))
    bn.train(train)
    with torch.no_grad():
        got = bn(torch.from_numpy(x)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-5)
    assert int(bn.num_batches_tracked) == int(train)


def test_conv_block_with_batchnorm_trains_as_flax():
    """``ConvBlock(use_bn=True)`` (the FlowNetC family's block) in train
    mode: output, gradient with respect to its input and updated statistics
    against flax's ``ConvBlock(use_bn=True)(x, train=True)``."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 10, 12)).astype(np.float32)
    block = ConvBlock(8, 16, use_bn=True)
    torch.nn.init.normal_(block[0].weight, 0.0, 0.2, generator=torch.Generator().manual_seed(1))
    perturb_batchnorm(block, torch.Generator().manual_seed(2))
    sd = block.state_dict()
    variables = {"params": {"Conv_0": {"kernel": sd["0.weight"].numpy().transpose(2, 3, 1, 0)},
                            "BatchNorm_0": {"scale": sd["1.weight"].numpy(),
                                            "bias": sd["1.bias"].numpy()}},
                 "batch_stats": {"BatchNorm_0": {"mean": sd["1.running_mean"].numpy(),
                                                 "var": sd["1.running_var"].numpy()}}}
    cot = rng.normal(size=(2, 10, 12, 16)).astype(np.float32)

    def f(xx):
        y, upd = jcommon.ConvBlock(16, use_bn=True).apply(variables, xx, train=True,
                                                          mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, upd)

    (_, (ref, upd)), gref = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(x.transpose(0, 2, 3, 1)))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = block.train()(xt)
    (y * torch.from_numpy(cot.transpose(0, 3, 1, 2))).sum().backward()
    ref = np.asarray(ref)
    np.testing.assert_allclose(y.detach().numpy().transpose(0, 2, 3, 1), ref,
                               atol=1e-5 * np.abs(ref).max())
    gref = np.asarray(gref)
    np.testing.assert_allclose(xt.grad.numpy().transpose(0, 2, 3, 1), gref,
                               atol=1e-5 * np.abs(gref).max())
    st = upd["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(block[1].running_mean.numpy(), np.asarray(st["mean"]), atol=1e-5)
    np.testing.assert_allclose(block[1].running_var.numpy(), np.asarray(st["var"]), rtol=1e-5)
