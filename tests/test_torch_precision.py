"""The mixed-precision policy of the port (``models.precision``) against
``ocflow_tpu.models.precision`` on the CPU: one net of each of the five
families of ``tests/test_bf16_joint.py``, seeded in the port (BatchNorm
statistics perturbed) and carried to flax through the JAX package's
converters (a flax ``init`` alone compiles for 17-26 s here), the same
numpy-seeded input through both ``apply_mixed`` in bf16, the JAX side
jitted as its steps are.

- Eval mode: every output fp32 and finite, within ``BF16_REL`` of the
  output's max|JAX| (the two bf16 bodies round in different places: a few
  bf16 ulps of the larger values), and apart from the port's own fp32
  output (the body really ran in bf16).
- Train mode with the statistics kept: the running means, and the running
  variances, of all the BatchNorms together (relative L2) within
  ``STATS_WITNESS`` times the JAX package's own gap between its bf16 and
  fp32 updates (read when the test was written: means 0.0089 against
  0.0094 in InpaintingNet, 0.0049 against 0.0048 in SimpleOcclusionNet;
  variances 0.0011 against 0.0026 and 0.0008 against 0.0023; on flax's own
  init the InpaintingNet means read 0.026 against 0.017: at 2x64x64 the
  deepest BatchNorms normalize 2 and 8 values a channel, and their small
  means carry the bf16 rounding of every layer before); the master
  parameters fp32 with fp32 gradients.
- One BatchNorm on an input exact in bf16: the update of the running
  statistics equals jitted flax's (``bf16(0.9) * bf16(ra) + 0.1 * batch``
  in fp32: XLA casts the weak-typed momentum and keeps the product's excess
  precision; flax op by op reads ``0.9 * bf16(ra)`` instead) to 1e-6 of
  max|stat|, and differs from the update rounded to bf16 as a whole; the
  outputs agree within a bf16 ulp.
- ``cast_floating`` leaves integer and boolean tensors alone; ``dtype=None``
  passes through.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocflow_torch.bench import perturb_batchnorm
from ocflow_torch.models import (FlowNetS, FlowOccNetCV, InpaintingNet, SimpleFlowNet,
                                 SimpleOcclusionNet, inpaintingnet_from_flax,
                                 simpleoccnet_from_flax)
from ocflow_torch.models.common import BatchNorm
from ocflow_torch.models.precision import apply_mixed, cast_floating, resolve_dtype
from ocflow_tpu import models as jmodels
from ocflow_tpu.models import torch_convert as tc
from ocflow_tpu.models.precision import apply_mixed as japply_mixed
from test_torch_ops import share_cores  # noqa: F401  (autouse)
from test_torch_zoo_nets import to_flax

BF16_REL = 2.0 ** -5
STATS_WITNESS = 2.0

FAMILIES = {
    "flownets": (FlowNetS, jmodels.FlowNetS, tc.convert_flownets, ("images",)),
    "simple_flow": (SimpleFlowNet, jmodels.SimpleFlowNet, tc.convert_simpleflownet,
                    ("images",)),
    "simple_occ": (SimpleOcclusionNet, jmodels.SimpleOcclusionNet,
                   tc.convert_simple_occlusion_net, ("images",)),
    "pwoc": (FlowOccNetCV, jmodels.FlowOccNetCV, tc.convert_flow_occ_net_cv, ("images",)),
    "inpainting": (InpaintingNet, jmodels.InpaintingNet, tc.convert_inpainting_net,
                   ("image3", "mask")),
}
# the port's bridges of the nets whose running statistics are compared
BRIDGES = {"simple_occ": simpleoccnet_from_flax, "inpainting": inpaintingnet_from_flax}


def _inputs(args, seed=0, b=2, h=64, w=64):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(-1, 1, (b, h, w, 6)).astype(np.float32)
    valid = (rng.uniform(size=(b, h, w, 1)) > 0.3).astype(np.float32)
    return [imgs if a == "images" else imgs[..., :3] if a == "image3" else valid for a in args]


def _pair(key):
    """The JAX net, the port's seeded net and its flax variables, the
    inputs."""
    port_cls, jax_cls, convert, args = FAMILIES[key]
    model = port_cls(generator=torch.Generator().manual_seed(0))
    perturb_batchnorm(model, torch.Generator().manual_seed(100))
    variables = to_flax(port_cls, convert, {k: v.clone() for k, v in model.state_dict().items()})
    return jax_cls(), variables, model, _inputs(args)


def _leaves(out):
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("key", list(FAMILIES))
def test_apply_mixed_matches_jax(key):
    jnet, variables, model, inputs = _pair(key)
    fn = jax.jit(lambda v, *a: japply_mixed(jnet.apply, v, *a, dtype=jnp.bfloat16))
    want = _leaves(fn(variables, *map(jnp.asarray, inputs)))
    x = [torch.from_numpy(a) for a in inputs]
    model.eval()
    with torch.no_grad():
        got = _leaves(apply_mixed(model, *x))
        fp32 = _leaves(apply_mixed(model, *x, dtype=None))
    for g, w, f in zip(got, want, fp32, strict=True):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        print(f"{key}: bf16 port vs JAX {err:.3e} of max|JAX|; port bf16 vs fp32 "
              f"{(g - f).abs().max().item():.3e}")
        assert err <= BF16_REL, err
        assert (g - f).abs().max().item() > 0.0
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("key", ["simple_occ", "inpainting"])
def test_apply_mixed_train_mode_keeps_stats_and_fp32_masters(key):
    jnet, variables, model, inputs = _pair(key)
    bridge = BRIDGES[key]
    x = [jnp.asarray(a) for a in inputs]

    def stats(dtype):
        fn = jax.jit(lambda v, *a: japply_mixed(jnet.apply, v, *a, dtype=dtype,
                                                mutable=["batch_stats"], train=True))
        upd = jax.tree_util.tree_map(np.asarray, fn(variables, *x)[1]["batch_stats"])
        return bridge({"params": variables["params"], "batch_stats": upd})

    want, witness = stats(jnp.bfloat16), stats(None)
    model.train()
    out = _leaves(apply_mixed(model, *[torch.from_numpy(a) for a in inputs]))
    sum(o.sum() for o in out).backward()
    got = model.state_dict()

    def rel_l2(a, b, kind):
        keys = [k for k in b if k.endswith(kind)]
        u = torch.cat([a[k].flatten() for k in keys])
        v = torch.cat([b[k].flatten() for k in keys])
        return ((u - v).norm() / v.norm()).item()

    for kind in ("running_mean", "running_var"):
        gap, own = rel_l2(got, want, kind), rel_l2(want, witness, kind)
        print(f"{key} {kind}: port vs JAX bf16 {gap:.3e}, JAX bf16 vs fp32 {own:.3e}")
        assert gap <= STATS_WITNESS * own, (kind, gap, own)
    assert all(v.dtype == torch.float32 for k, v in got.items() if "running" in k)
    for p in model.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32


class _FlaxBN(fnn.Module):
    @fnn.compact
    def __call__(self, x, train=False):
        return fnn.BatchNorm(use_running_average=not train, momentum=0.9, epsilon=1e-5)(x)


def test_batchnorm_update_rounds_as_flax_does():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 6, 4)).astype(np.float32)
    x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))  # exact in bf16
    mean0 = rng.normal(size=4).astype(np.float32)
    var0 = rng.uniform(0.5, 2.0, size=4).astype(np.float32)
    variables = {"params": {"BatchNorm_0": {"scale": np.full(4, 1.5, np.float32),
                                            "bias": np.full(4, 0.25, np.float32)}},
                 "batch_stats": {"BatchNorm_0": {"mean": mean0, "var": var0}}}
    out, upd = jax.jit(lambda v, a: japply_mixed(_FlaxBN().apply, v, a, dtype=jnp.bfloat16,
                                                 mutable=["batch_stats"], train=True))(
        variables, jnp.asarray(x))
    bn = BatchNorm(4)
    with torch.no_grad():
        bn.weight.fill_(1.5)
        bn.bias.fill_(0.25)
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    got = apply_mixed(bn.train(), torch.from_numpy(x.copy()).permute(0, 3, 1, 2))
    for name, stat in (("mean", bn.running_mean), ("var", bn.running_var)):
        want = np.asarray(upd["batch_stats"]["BatchNorm_0"][name])
        assert np.abs(stat.numpy() - want).max() <= 1e-6 * np.abs(want).max(), name
        whole = stat.to(torch.bfloat16).float().numpy()  # the update rounded as a whole
        assert np.abs(whole - want).max() > 1e-4
    got = got.detach().permute(0, 2, 3, 1).numpy()
    assert np.abs(got - np.asarray(out)).max() <= 2.0 ** -7 * np.abs(np.asarray(out)).max()


def test_cast_floating_and_the_pass_through():
    tree = {"a": torch.ones(3), "b": torch.arange(3), "c": (torch.tensor([True]), 2.0)}
    out = cast_floating(tree, torch.bfloat16)
    assert out["a"].dtype == torch.bfloat16 and out["b"].dtype == torch.int64
    assert out["c"][0].dtype == torch.bool and out["c"][1] == 2.0
    assert resolve_dtype(None) is resolve_dtype("float32") is None
    assert resolve_dtype("bfloat16") is torch.bfloat16
    model = torch.nn.Linear(3, 2)
    x = torch.randn(4, 3)
    assert torch.equal(apply_mixed(model, x, dtype=None), model(x))
