"""The port's spectral norm (``ocflow_torch.models.gated_conv.SNConv2d``, the
semantics of ``flax.linen.SpectralNorm``) and the two SN-PatchGAN
discriminators against ``ocflow_tpu/models/gated_conv.py`` on the CPU.

Flax's spectral norm runs one step of power iteration in every mode, from
the stored ``u``, and stores ``u`` and ``sigma`` only with ``update_stats``
(train mode); ``torch.nn.utils.spectral_norm`` skips the iteration in eval
mode. So every eval forward here starts from a ``u`` that has not
converged (a fresh normal draw, or one step past it), where the two
differ. Weights and ``u`` are flax's (``init`` from a seed) carried across
with ``discriminator_from_flax``; inputs from a numpy seed at 2x64x128 (the
discriminators' five stride-2 maps end at 1x3 there; at 32x64 the fifth
has no row: ``in/2 - 1`` each, the reference's padding). fp32: outputs
within 1e-5 of max|out|, ``u`` and ``sigma`` within 1e-5; fp64
(``jax.enable_x64``): 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocflow_torch.models import (InpaintSADiscriminator, InpaintSADiscriminatorOrg,
                                 discriminator_from_flax)
from ocflow_torch.models import gated_conv as tg
from ocflow_tpu.models import gated_conv as jg
from test_torch_ops import share_cores  # noqa: F401  (autouse)

TOL = {"fp32": 1e-5, "fp64": 1e-12}
NETS = {"gated": (jg.InpaintSADiscriminator, InpaintSADiscriminator, True),
        "gated_org": (jg.InpaintSADiscriminatorOrg, InpaintSADiscriminatorOrg, False)}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _cast(tree, kind):
    dt = np.float64 if kind == "fp64" else np.float32
    return jax.tree_util.tree_map(lambda a: np.array(a, dt), tree)


def _sn_leaves(tree):
    """``{path: array}`` of the spectral norms' ``u`` and ``sigma`` in a
    flax ``batch_stats`` tree."""
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _port_sn(model):
    return {k: v.numpy() for k, v in model.state_dict().items() if k.endswith((".u", ".sigma"))}


@pytest.mark.parametrize("kind", ["fp32", "fp64"])
def test_sn_conv_matches_flax_spectral_norm(kind):
    """One spectral-norm conv (kernel 5, stride 2, 16 -> 24 channels): the
    eval forward and its gradients (input and kernel: ``sigma`` carries the
    kernel's gradient, ``u`` and ``v`` held constant) from the drawn ``u``,
    ``u`` left as it was; then a train forward, ``u`` and ``sigma`` stored,
    against flax's ``update_stats=True``."""
    rng = np.random.default_rng(1)
    npdt = np.float64 if kind == "fp64" else np.float32
    x = rng.normal(size=(2, 16, 20, 16)).astype(npdt)
    g = rng.normal(size=(2, 7, 9, 24)).astype(npdt)
    jmod = jg._Conv(24, 5, 2, spectral_norm=True)
    with jax.enable_x64(kind == "fp64"):
        v = _cast(jax.jit(lambda a: jmod.init(jax.random.PRNGKey(2), a))(x[:, :, :, :]), kind)

        def fwd(params, a):
            return jmod.apply({"params": params, "batch_stats": v["batch_stats"]}, a)

        out, vjp = jax.vjp(jax.jit(fwd), v["params"], jnp.asarray(x))
        dparams, dx = vjp(jnp.asarray(g))
        tout, upd = jax.jit(lambda a: jmod.apply(v, a, update_stats=True,
                                                 mutable=["batch_stats"]))(x)

    dt = torch.float64 if kind == "fp64" else torch.float32
    conv = tg._conv(16, 24, 5, 2, spectral_norm=True).to(dt)
    sn = v["batch_stats"]["SpectralNorm_0"]
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(v["params"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1)))
        conv.bias.copy_(torch.from_numpy(v["params"]["Conv_0"]["bias"]))
        conv.u.copy_(torch.from_numpy(sn["Conv_0/kernel/u"]))
    u0 = conv.u.clone()
    conv.eval()
    tx = torch.from_numpy(x.transpose(0, 3, 1, 2)).requires_grad_()
    got = conv(tx)
    got.backward(torch.from_numpy(g.transpose(0, 3, 1, 2)))
    assert torch.equal(conv.u, u0) and conv.sigma.item() == 1.0
    assert _rel(got.detach().permute(0, 2, 3, 1).numpy(), out) <= TOL[kind]
    assert _rel(tx.grad.permute(0, 2, 3, 1).numpy(), dx) <= TOL[kind]
    assert _rel(conv.weight.grad.permute(2, 3, 1, 0).numpy(),
                dparams["Conv_0"]["kernel"]) <= TOL[kind]
    assert _rel(conv.bias.grad.numpy(), dparams["Conv_0"]["bias"]) <= TOL[kind]

    conv.train()
    with torch.no_grad():
        got = conv(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    want_sn = upd["batch_stats"]["SpectralNorm_0"]
    assert _rel(got.permute(0, 2, 3, 1).numpy(), tout) <= TOL[kind]
    assert _rel(conv.u.numpy(), want_sn["Conv_0/kernel/u"]) <= TOL[kind]
    assert _rel(conv.sigma.numpy(), want_sn["Conv_0/kernel/sigma"]) <= TOL[kind]
    assert not torch.equal(conv.u, u0)


@pytest.mark.parametrize("kind", ["fp32", "fp64"])
@pytest.mark.parametrize("key", ["gated", "gated_org"])
def test_discriminator_matches_flax(key, kind):
    """Eval forward (no ``u`` stored), train forward (every ``u`` and
    ``sigma`` stored, against flax's updated ``batch_stats``), then an eval
    forward from the stored ``u`` (one step past the draw); the output
    flattened in NHWC order, [2, 1 * 3 * 256]."""
    jcls, tcls, projected = NETS[key]
    rng = np.random.default_rng(5)
    npdt = np.float64 if kind == "fp64" else np.float32
    x = rng.uniform(-1, 1, (2, 64, 128, 4)).astype(npdt)
    jnet = jcls()
    with jax.enable_x64(kind == "fp64"):
        v = _cast(jax.jit(jnet.init)(jax.random.PRNGKey(3), x), kind)
        apply = jax.jit(lambda v, a: jnet.apply(v, a))
        want_eval = np.asarray(apply(v, x))
        want_train, upd = jax.jit(lambda v, a: jnet.apply(
            v, a, train=True, mutable=["batch_stats"]))(v, x)
        stepped = {"params": v["params"], "batch_stats": _cast(upd["batch_stats"], kind)}
        want_again = np.asarray(apply(stepped, x))

    dt = torch.float64 if kind == "fp64" else torch.float32
    model = tcls().to(dt)
    model.load_state_dict(discriminator_from_flax(v, projected))
    model = model.to(dt)
    tx = torch.from_numpy(x)
    before = _port_sn(model)
    model.eval()
    with torch.no_grad():
        got_eval = model(tx).numpy()
    assert all(np.array_equal(before[k], w) for k, w in _port_sn(model).items())
    assert got_eval.shape == want_eval.shape == (2, 768)
    assert _rel(got_eval, want_eval) <= TOL[kind]

    model.train()
    with torch.no_grad():
        got_train = model(tx).numpy()
    assert _rel(got_train, want_train) <= TOL[kind]
    want_sn = discriminator_from_flax(stepped, projected)
    for k, w in _port_sn(model).items():
        assert _rel(w, want_sn[k].numpy()) <= TOL[kind], k

    model.eval()
    with torch.no_grad():
        got_again = model(tx).numpy()
    assert _rel(got_again, want_again) <= TOL[kind]


def test_eval_forward_iterates_where_torch_spectral_norm_would_not():
    """After one train forward (``u`` stepped once from its draw), the
    port's eval forward runs one more power-iteration step, as flax's does:
    it equals flax's eval forward and stays clear of the output of the
    kernel divided by the stored ``sigma`` (what ``torch.nn.utils
    .spectral_norm`` serves in eval mode) by more than the tolerance."""
    rng = np.random.default_rng(6)
    x = rng.uniform(-1, 1, (2, 64, 128, 4)).astype(np.float32)
    jnet = jg.InpaintSADiscriminatorOrg()
    v = _cast(jax.jit(jnet.init)(jax.random.PRNGKey(4), x), "fp32")
    _, upd = jax.jit(lambda v, a: jnet.apply(v, a, train=True, mutable=["batch_stats"]))(v, x)
    stepped = {"params": v["params"], "batch_stats": _cast(upd["batch_stats"], "fp32")}
    want = np.asarray(jax.jit(lambda v, a: jnet.apply(v, a))(stepped, x))
    model = InpaintSADiscriminatorOrg()
    model.load_state_dict(discriminator_from_flax(stepped, projected=False))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        y = torch.from_numpy(x).permute(0, 3, 1, 2)
        for block in model.discriminator_net:
            c = block.conv2d
            y = torch.nn.functional.leaky_relu(c._conv_forward(y, c.weight / c.sigma, c.bias), 0.2)
        torch_style = y.permute(0, 2, 3, 1).reshape(2, -1).numpy()
    assert _rel(got, want) <= TOL["fp32"]
    assert _rel(torch_style, want) > 10 * TOL["fp32"]


def test_seeded_init_draws_u_and_sets_sigma_to_one():
    """``init_gated``: truncated LeCun-normal kernels, zero biases, every
    ``u`` from a standard normal and every ``sigma`` 1; the same seed the
    same weights."""
    a = InpaintSADiscriminator(generator=torch.Generator().manual_seed(7))
    b = InpaintSADiscriminator(generator=torch.Generator().manual_seed(7))
    sd = a.state_dict()
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in sd.items())
    us = torch.cat([v.flatten() for k, v in sd.items() if k.endswith(".u")])
    assert all(v.item() == 1.0 for k, v in sd.items() if k.endswith(".sigma"))
    assert all(not v.any() for k, v in sd.items() if k.endswith(".bias"))
    assert us.numel() > 1000 and abs(us.mean().item()) < 0.1 and abs(us.std().item() - 1) < 0.1
    w = sd["discriminator_net.4.conv2d.conv2.weight"]
    fan_in = w[0].numel()
    assert abs(w.std().item() * fan_in ** 0.5 - 1.0) < 0.1 and w.abs().max() * fan_in ** 0.5 <= 2.28
