"""The port's training slice == ``ocflow_tpu``'s, on the CPU: the cost-volume
VJP, ``conv_group_diff``, the gradient-carrying pair and the unsupervised
step.

Inputs are seeded numpy arrays handed to both packages; weights cross
through ``convert_flownetcv`` (port -> flax) and gradients back through
``flownetcv_from_flax`` (flax tree -> port names; the mapping is a
permutation of entries, so a gradient tree maps exactly as params do).
Tolerances are stated where they are used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ocflow_torch.kernels.conv_chain import (ConvSpec, conv_group_diff, conv_group_plain,
                                             pack_weights, prepare_group)
from ocflow_torch.kernels.cost_volume import cost_volume, cost_volume_backward_plain
from ocflow_torch.models import (FlowNetCV, calibrate_q8, fast_apply, fast_apply_pair,
                                 flownetcv_from_flax)
from ocflow_torch.train import (LONGRUN_SYNTHETIC, config_from_dict, create_train_state,
                                load_config, make_unsupervised_flow_step)
from ocflow_tpu.models import pwc_net as jpwc
from ocflow_tpu.models.torch_convert import convert_flownetcv
from ocflow_tpu.ops.pallas import cost_volume_kernel as jcv
from ocflow_tpu.ops.pallas.conv_chain_kernel import ConvSpec as JSpec
from ocflow_tpu.ops.pallas.conv_chain_kernel import conv_group_diff as j_conv_group_diff
from ocflow_tpu.train import load_config as j_load_config
from test_torch_ops import share_cores  # noqa: F401  (autouse)
from test_torch_step import HP, smooth_batch

B, H, W = 2, 64, 128


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _model(seed=0):
    return FlowNetCV(generator=torch.Generator().manual_seed(seed))


def _rel(got, want):
    """max|got - want| / max|want|."""
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- cost-volume VJP --------------------------------------------------------

def test_cost_volume_backward_plain_matches_jax():
    """The port's plain backward == ``cost_volume_kernel._bwd`` (the XLA
    mirror), at the case of tests/test_ops_cost_volume.py:68, atol 2e-3 as
    there."""
    rng = np.random.default_rng(42)
    f1 = rng.standard_normal((2, 8, 128, 16)).astype(np.float32)
    f2 = rng.standard_normal((2, 8, 128, 16)).astype(np.float32)
    g = rng.standard_normal((2, 8, 128, 81)).astype(np.float32)
    want = jcv._bwd(4, (jnp.asarray(f1), jnp.asarray(f2)), jnp.asarray(g))
    got = cost_volume_backward_plain(_nchw(f1), _nchw(f2), _nchw(g), 4)
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(_nhwc(gt), np.asarray(wt), atol=2e-3)


def test_cost_volume_gradcheck():
    """The differentiable cost volume's backward is the adjoint of its
    forward (float64, finite differences)."""
    gen = torch.Generator().manual_seed(0)
    f1, f2 = (torch.randn(1, 3, 5, 6, dtype=torch.float64, generator=gen,
                          requires_grad=True) for _ in range(2))
    assert torch.autograd.gradcheck(lambda a, b: cost_volume(a, b, 4), (f1, f2),
                                    fast_mode=True)


# -- conv_group_diff ---------------------------------------------------------

def _conv_ref(x, w, b, d=1, act=True):
    y = torch.nn.functional.conv2d(x, w, b, padding=d, dilation=d)
    return torch.nn.functional.leaky_relu(y, 0.1) if act else y


@pytest.mark.parametrize("case", ["dilated", "narrow"])
def test_conv_group_diff_matches_jax(case):
    """Gradients of ``conv_group_diff`` == those of JAX ``conv_group_diff``
    (Pallas forward in interpret mode, XLA adjoint) and of autograd of the
    eager chain: the case of tests/test_pwc_fast.py:237 (2x8x128, a
    dilation-2 conv reading the input and the first block) and a narrow one
    (4x8x64, no activation on the second conv), which the JAX kernel runs
    lane-packed, two images per 128-lane row, as at :277 (a TPU layout; the
    port runs it as it is); atol 5e-3, rtol 1e-4 as there."""
    rng = np.random.default_rng(4 if case == "dilated" else 9)
    b, h, w, c0 = (2, 8, 128, 16) if case == "dilated" else (4, 8, 64, 16)
    c2, d2, act2 = (16, 2, True) if case == "dilated" else (8, 1, False)
    x = rng.normal(size=(b, h, w, c0)).astype(np.float32)
    w1 = (rng.normal(size=(3, 3, c0, 24)) * 0.1).astype(np.float32)
    b1 = rng.normal(size=(24,)).astype(np.float32)
    w2a = (rng.normal(size=(3, 3, c0, c2)) * 0.1).astype(np.float32)
    w2b = (rng.normal(size=(3, 3, 24, c2)) * 0.1).astype(np.float32)
    b2 = rng.normal(size=(c2,)).astype(np.float32)
    gseed = rng.normal(size=(b, h, w, c2)).astype(np.float32)
    g1seed = rng.normal(size=(b, h, w, 24)).astype(np.float32)

    jspecs = (JSpec(reads=(0,), cout=24, emit=True),
              JSpec(reads=(0, 1), cout=c2, dilation=d2, act=act2, emit=True))

    def jloss(xx, ws, bs):
        if w % 128:
            c1, c2_ = j_conv_group_diff([xx], ws, bs, jspecs, h, 128, 4, w, True)
        else:
            c1, c2_ = j_conv_group_diff([xx], ws, bs, jspecs, h, w, 4, None, True)
        return jnp.sum(c2_ * gseed) + jnp.sum(c1 * g1seed)

    jx, jws, jbs = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), [[jnp.asarray(w1)], [jnp.asarray(w2a), jnp.asarray(w2b)]],
        [jnp.asarray(b1), jnp.asarray(b2)])
    want = {"x": np.asarray(jx).transpose(0, 3, 1, 2),
            "w1": np.asarray(jws[0][0]).transpose(3, 2, 0, 1),
            "w2": np.concatenate([np.asarray(jws[1][0]), np.asarray(jws[1][1])],
                                 2).transpose(3, 2, 0, 1),
            "b1": np.asarray(jbs[0]), "b2": np.asarray(jbs[1])}

    def leaves():
        t = {"x": _nchw(x), "w1": torch.from_numpy(w1.transpose(3, 2, 0, 1).copy()),
             "w2": torch.from_numpy(np.concatenate([w2a, w2b], 2).transpose(3, 2, 0, 1).copy()),
             "b1": torch.from_numpy(b1), "b2": torch.from_numpy(b2)}
        return {k: v.requires_grad_() for k, v in t.items()}

    specs = [ConvSpec((0,), 24), ConvSpec((0, 1), c2, dilation=d2, act=act2)]
    fast = leaves()
    c1, c2_ = conv_group_diff([fast["x"]], [fast["w1"], fast["w2"]],
                              [fast["b1"], fast["b2"]], specs)
    ((c2_ * _nchw(gseed)).sum() + (c1 * _nchw(g1seed)).sum()).backward()
    eager = leaves()
    e1 = _conv_ref(eager["x"], eager["w1"], eager["b1"])
    e2 = _conv_ref(torch.cat([eager["x"], e1], 1), eager["w2"], eager["b2"], d2, act2)
    ((e2 * _nchw(gseed)).sum() + (e1 * _nchw(g1seed)).sum()).backward()
    for k, wt in want.items():
        np.testing.assert_allclose(fast[k].grad.numpy(), wt, atol=5e-3, rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(fast[k].grad.numpy(), eager[k].grad.numpy(),
                                   atol=5e-3, rtol=1e-4, err_msg=k)


def test_packed_group_is_a_snapshot_of_fp32_weights():
    """A packed conv group keeps the weights it was packed with: an in-place
    update of fp32 source weights (an optimizer step) reaches neither its
    kernel packing nor its plain version, so the two stay one function.
    (Before the fix the plain version aliased fp32 weights on their own
    device and followed the update while the packing did not.)"""
    rng = np.random.default_rng(6)
    w = torch.from_numpy(rng.normal(size=(8, 4, 3, 3)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(8,)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(1, 4, 6, 7)).astype(np.float32))
    w0 = w.clone()
    group = prepare_group([w], [b], [ConvSpec((0,), 8, emit=True)], 1,
                          torch.float32, "cpu")
    (before,) = conv_group_plain([x], group)
    with torch.no_grad():
        w.add_(1.0)
        b.add_(1.0)
    (after,) = conv_group_plain([x], group)
    assert torch.equal(before, after)
    assert torch.equal(group.packed[0], pack_weights(w0, torch.float32))


# -- the gradient-carrying pair ----------------------------------------------

def _grads(model):
    return {n: p.grad.numpy() for n, p in model.named_parameters()}


# Gradient bound of the pair (per parameter, max|fused - ref| / max|ref|,
# fp32, 2x64x128 smooth images): the fused path, the eager module and flax
# sum the same terms in another order through ~30 layers and feature warps
# whose bilinear weights switch at integer coordinates. Measured at most
# 1.9e-5 against the eager module and 6.4e-5 against JAX on seeds 3-5
# (pixel-noise images reach 1.6e-2 against JAX: their features are noise,
# and a flow difference of 1e-5 moves whole warp taps).
PAIR_GRAD_REL = 1e-3


def test_fast_apply_pair_grads_match_eager_and_jax():
    """Through a fixed cotangent on (flow_full, flow_quarter): the pair's
    parameter gradients == autograd of the eager ``FlowNetCV`` and
    ``jax.grad`` of JAX ``FlowNetCV.apply``; its backward pair == the
    port's ``fast_apply`` on the swapped input."""
    rng = np.random.default_rng(3)
    x = smooth_batch(3)["images"]
    gf = rng.normal(size=(B, H, W, 2)).astype(np.float32)
    gq = rng.normal(size=(B, H // 4, W // 4, 2)).astype(np.float32)
    model = _model(0)
    variables = convert_flownetcv(model.state_dict())

    (full, quarter), back = fast_apply_pair(model, torch.from_numpy(x), device="cpu")
    ((full * torch.from_numpy(gf)).sum() + (quarter * torch.from_numpy(gq)).sum()).backward()
    fused = _grads(model)
    model.zero_grad()
    full_e, quarter_e = model(torch.from_numpy(x))
    ((full_e * torch.from_numpy(gf)).sum() + (quarter_e * torch.from_numpy(gq)).sum()).backward()
    eager = _grads(model)

    def jloss(params):
        f, q = jpwc.FlowNetCV().apply({"params": params}, jnp.asarray(x))
        return jnp.sum(f * gf) + jnp.sum(q * gq)

    jgrads = flownetcv_from_flax(jax.jit(jax.grad(jloss))(variables["params"]))
    assert set(jgrads) == set(fused)
    for name, g in fused.items():
        assert np.abs(g).max() > 0, name
        for ref in (eager[name], jgrads[name].numpy()):
            assert _rel(g, ref) <= PAIR_GRAD_REL, (name, _rel(g, ref))

    swapped = torch.from_numpy(np.concatenate([x[..., 3:], x[..., :3]], -1))
    for got, want in zip(back, fast_apply(model, swapped, device="cpu")):
        assert not got.requires_grad
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5 * want.abs().max().item())


# -- port-internal checks ------------------------------------------------------

def _port_step(hp, seed=0, batch=None):
    model = _model(seed)
    state = create_train_state(model, 1e-4, device="cpu")
    step, _ = make_unsupervised_flow_step(hp)
    batch = batch or {k: torch.from_numpy(v) for k, v in smooth_batch().items()}
    state, metrics = step(state, batch)
    return model, metrics


def test_fused_step_equals_eager_step():
    """``fast_forward='both'`` == ``'off'`` (the eager network under
    autograd) in fp32: metrics rtol 5e-5 (measured 7.6e-6 on seeds 1-3);
    gradients within PAIR_GRAD_REL (measured 1.6e-4); every parameter gets
    a non-zero gradient on the fused path."""
    fused, m_fused = _port_step(HP)
    eager, m_eager = _port_step({**HP, "fast_forward": "off"})
    for k in m_fused:
        np.testing.assert_allclose(float(m_fused[k]), float(m_eager[k]), rtol=5e-5, err_msg=k)
    for (name, p), q in zip(fused.named_parameters(), eager.parameters()):
        assert p.grad is not None and p.grad.abs().max() > 0, name
        assert _rel(p.grad.numpy(), q.grad.numpy()) <= PAIR_GRAD_REL, name


def test_backward_decode_sees_the_updated_weights():
    """After an optimizer step the pair's no-grad backward decode runs on
    the new weights (the packed copy is rebuilt), not the packed old ones."""
    model = _model(1)
    state = create_train_state(model, 1e-2, device="cpu")
    step, _ = make_unsupervised_flow_step(HP)
    batch = {k: torch.from_numpy(v) for k, v in smooth_batch(2, h=64, w=64).items()}
    x = batch["images"]
    _, before = fast_apply_pair(model, x, device="cpu")
    step(state, batch)
    _, after = fast_apply_pair(model, x, device="cpu")
    fresh = FlowNetCV()
    fresh.load_state_dict(model.state_dict())
    swapped = torch.cat([x[..., 3:], x[..., :3]], -1)
    for a, b, w in zip(after, before, fast_apply(fresh, swapped, device="cpu")):
        assert not torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=1e-5 * w.abs().max().item())


# W8A8 backward decode: its flow only feeds the range-map occlusion, so the
# step's loss moves by the occlusion mask's change; measured 0.02-0.29% for
# model seeds 0-2 at 2x64x128 (the JAX package's CPU fallback ignores
# q8_backward, so this check is the port's own).
Q8_LOSS_REL = 0.03


def test_q8_backward_step_runs_close_to_exact():
    batch = {k: torch.from_numpy(v) for k, v in smooth_batch(4).items()}
    x = batch["images"]
    scales = calibrate_q8(_model(0), torch.cat([x[..., 3:], x[..., :3]], -1), device="cpu")
    _, exact = _port_step(HP, batch=batch)
    _, q8 = _port_step({**HP, "q8_backward": scales}, batch=batch)
    assert all(torch.isfinite(v) for v in q8.values())
    rel = abs(float(q8["loss"]) - float(exact["loss"])) / float(exact["loss"])
    assert rel <= Q8_LOSS_REL, rel


def test_longrun_config_dict_matches_yaml():
    want = load_config("configs/longrun_synthetic.yaml").as_hparams()
    assert config_from_dict(LONGRUN_SYNTHETIC).as_hparams() == want
    assert j_load_config("configs/longrun_synthetic.yaml").as_hparams() == want


def test_adam_matches_optax():
    """torch.optim.Adam == optax.adam on the same parameters and gradients,
    three steps (1e-7: fp32 rounding of the same formula)."""
    rng = np.random.default_rng(5)
    p0 = rng.normal(size=(7, 5)).astype(np.float32)
    grads = [rng.normal(size=(7, 5)).astype(np.float32) * s for s in (1.0, 1e-3, 10.0)]
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = torch.optim.Adam([p], lr=1e-3)
    tx = optax.adam(1e-3)
    jp = jnp.asarray(p0)
    st = tx.init(jp)
    for g in grads:
        p.grad = torch.from_numpy(g)
        opt.step()
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), atol=1e-7)


def test_train_bench_runs_on_cpu():
    """The training bench's loop at a tiny size on the CPU."""
    from ocflow_torch import bench

    hp = {**bench.train_hparams(), "compute_dtype": "float32"}
    state, step, batch = bench.make_train_inputs(1, 64, 64, "cpu", 0, hp)
    res = bench.measure_train(state, step, batch, iters=1, warmup=0)
    assert res["ms_per_step"] > 0 and state.step == 1
