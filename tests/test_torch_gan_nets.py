"""The port's gated-conv generators (``InpaintSANet``, ``InpaintSANetOrg``)
against ``ocflow_tpu/models/gated_conv.py`` on the CPU at 2x32x64 (``cnum``
32 as shipped; the refine trunk's 8x16 = 128 tokens take the dense
attention, the blockwise path is held in ``tests/test_torch_gan_attention.py``).

Seeded weights with ``gamma`` set to 0.5 (it starts at 0, which would hide
the attention) and the BatchNorms' scales, biases and running statistics
perturbed from a numpy seed, carried to flax by the JAX package's
``convert_inpaint_sanet`` and back by ``inpaintsanet_from_flax`` /
``inpaintsanetorg_from_flax``; images and masks from a numpy seed. Eval and
train mode, the coarse and the refined output, and the running statistics a
train forward leaves: fp64 (``jax.enable_x64``) within 1e-10 of max|out|
(of max|stat|); fp32 within 1e-4, in train mode against the JAX forward in
fp64. The train-mode BatchNorms normalize by the batch, and each package's
fp32 train forward lies up to 5e-5 (flax) and 7e-5 (the port) of max|out|
from the fp64 one on these inputs, so the two fp32 forwards read up to
1.1e-4 apart (measured on the CPU when the nets were ported; eval mode 3e-7
to 7e-7, fp64 1e-13).
``remat=True`` (``torch.utils.checkpoint`` around each gated block, its
BatchNorms frozen in the recompute) against ``remat=False`` in train mode:
outputs, gradients and running statistics equal bit for bit, each
statistic updated once.
"""

import jax
import numpy as np
import pytest
import torch

from ocflow_torch.models import (InpaintSANet, InpaintSANetOrg, inpaintsanet_from_flax,
                                 inpaintsanetorg_from_flax)
from ocflow_torch.models.common import BatchNorm
from ocflow_tpu.models import gated_conv as jg
from ocflow_tpu.models import torch_convert as tc
from test_torch_ops import share_cores  # noqa: F401  (autouse)

TOL = {"fp32": 1e-4, "fp64": 1e-10}
NETS = {"gated": (jg.InpaintSANet, InpaintSANet, inpaintsanet_from_flax, True),
        "gated_org": (jg.InpaintSANetOrg, InpaintSANetOrg, inpaintsanetorg_from_flax, False)}
B, H, W = 2, 32, 64


def inputs(seed=0, b=B, h=H, w=W):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32)
    masks = (rng.uniform(size=(b, h, w, 1)) > 0.6).astype(np.float32)
    return imgs, masks


def flax_variables(key, seed=0):
    """A seeded port generator (``init_gated``) with ``gamma`` 0.5 and every
    BatchNorm's scale, bias and running statistics perturbed from a numpy
    seed, as the flax variables the JAX package's ``convert_inpaint_sanet``
    makes of it (numpy, fp32)."""
    _, tcls, _, projected = NETS[key]
    model = tcls(generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(100 + seed)
    draw = {"running_mean": lambda n: rng.normal(0, 0.1, n),
            "running_var": lambda n: rng.uniform(0.5, 1.5, n)}
    with torch.no_grad():
        model.refine_attn.gamma.fill_(0.5)
        for m in model.modules():
            if isinstance(m, BatchNorm):
                n = m.num_features
                m.weight.copy_(torch.from_numpy(rng.uniform(0.8, 1.2, n)))
                m.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, n)))
                for name, f in draw.items():
                    getattr(m, name).copy_(torch.from_numpy(f(n)))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    return jax.tree_util.tree_map(np.asarray, tc.convert_inpaint_sanet(sd, projected=projected))


def port_model(key, variables, dtype=torch.float32, remat=False):
    _, tcls, convert, _ = NETS[key]
    model = tcls(remat=remat)
    model.load_state_dict(convert(variables))
    return model.to(dtype)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _cast(tree, kind):
    dt = np.float64 if kind == "fp64" else np.float32
    return jax.tree_util.tree_map(lambda a: np.asarray(a, dt), tree)


@pytest.mark.parametrize("kind", ["fp32", "fp64"])
@pytest.mark.parametrize("key", ["gated", "gated_org"])
def test_generator_matches_jax(key, kind):
    """Eval forward, train forward and the statistics it leaves (the
    port's running statistics against flax's ``batch_stats`` after
    ``mutable=['batch_stats']``)."""
    jcls, _, convert, _ = NETS[key]
    v = flax_variables(key)
    imgs, masks = inputs(1)
    npdt = np.float64 if kind == "fp64" else np.float32
    jnet = jcls()

    @jax.jit
    def forwards(v, a, m):
        return jnet.apply(v, a, m), jnet.apply(v, a, m, train=True, mutable=["batch_stats"])

    with jax.enable_x64(kind == "fp64"):
        want_eval, (want_train, upd) = forwards(_cast(v, kind), imgs.astype(npdt),
                                                masks.astype(npdt))
        want_stats = convert({"params": v["params"], "batch_stats": _cast(upd["batch_stats"],
                                                                           kind)})
    if kind == "fp32":
        # the fp32 train forward is held against the JAX one in fp64
        with jax.enable_x64(True):
            _, (want_train, _) = forwards(_cast(v, "fp64"), imgs.astype(np.float64),
                                          masks.astype(np.float64))
    imgs, masks = imgs.astype(npdt), masks.astype(npdt)
    model = port_model(key, v, torch.float64 if kind == "fp64" else torch.float32)
    ti, tm = torch.from_numpy(imgs), torch.from_numpy(masks)
    model.eval()
    with torch.no_grad():
        got_eval = model(ti, tm)
    model.train()
    with torch.no_grad():
        got_train = model(ti, tm)
    for name, got, want in (("eval", got_eval, want_eval), ("train", got_train, want_train)):
        for part, g, w in zip(("coarse", "refined"), got, want, strict=True):
            assert g.shape == (B, H, W, 3), (name, part)
            assert _rel(g.numpy(), w) <= TOL[kind], (name, part, _rel(g.numpy(), w))
    sd = model.state_dict()
    for k, w in want_stats.items():
        if "running" in k:
            assert _rel(sd[k].numpy(), w.numpy()) <= TOL[kind], k
    if key == "gated_org":
        assert all(g.abs().max() <= 1.0 for g in (*got_eval, *got_train))


@pytest.mark.parametrize("key", ["gated", "gated_org"])
def test_remat_equals_no_remat_in_train_mode(key):
    """One train-mode forward and backward (a seeded cotangent on both
    outputs) with ``remat`` on and off from the same weights: outputs,
    every parameter's gradient and every running statistic equal bit for
    bit; every BatchNorm counted one batch."""
    v = flax_variables(key, seed=2)
    imgs, masks = (torch.from_numpy(a) for a in inputs(3))
    rng = np.random.default_rng(4)
    cot = [torch.from_numpy(rng.normal(size=(B, H, W, 3)).astype(np.float32)) for _ in range(2)]
    runs = []
    for remat in (False, True):
        model = port_model(key, v, remat=remat).train()
        out = model(imgs, masks)
        sum((o * c).sum() for o, c in zip(out, cot)).backward()
        runs.append((out, model))
    (out0, m0), (out1, m1) = runs
    assert all(torch.equal(a, b) for a, b in zip(out0, out1))
    for (name, p0), p1 in zip(m0.named_parameters(), m1.parameters()):
        assert p0.grad is not None and torch.equal(p0.grad, p1.grad), name
    assert all(torch.equal(a, b) for a, b in zip(m0.state_dict().values(),
                                                  m1.state_dict().values()))
    norms = [m for m in m1.modules() if isinstance(m, BatchNorm)]
    assert len(norms) == 35 and all(m.num_batches_tracked.item() == 1 for m in norms)


@pytest.mark.parametrize("key", ["gated", "gated_org"])
def test_state_dict_names_are_the_reference_networks(key):
    """A seeded port generator's ``state_dict`` through the JAX package's
    ``convert_inpaint_sanet`` (which reads the reference torch network's
    names) and back through the port's converter is the same
    ``state_dict``; ``init_gated`` starts ``gamma`` at 0 and every
    BatchNorm at the identity."""
    _, tcls, convert, projected = NETS[key]
    model = tcls(generator=torch.Generator().manual_seed(5))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    back = convert(tc.convert_inpaint_sanet(sd, projected=projected))
    assert set(back) == set(sd)
    assert all(torch.equal(back[k], v) for k, v in sd.items() if "num_batches" not in k)
    assert sd["refine_attn.gamma"].item() == 0.0
    assert all(not v.any() for k, v in sd.items() if k.endswith("running_mean"))
    assert all(torch.equal(v, torch.ones_like(v)) for k, v in sd.items()
               if k.endswith("running_var"))
