"""OCFlowNet against the JAX package's, on the CPU at 2x64x128: the port's
seeded nets (running statistics perturbed from a seed) cross to flax
through the JAX package's ``convert_simple_flow_occ_net`` and
``convert_inpainting_net``, and come back through the port's
``ocflownet_from_flax``.

Eval mode (fp32): flow and completed frame within 1e-4 of max|out|, the
hard occlusion equal wherever the soft value lies at least 1e-4 from 0.5.
Train mode in fp64 (``jax_enable_x64``): the flow within 1e-6 of max|flow|,
the completed frame within 1e-4 of max (both packages' warps take fp32
sampling coordinates, ``ops/warp.py`` of either, and the inpainter's
train-mode BatchNorms carry that far: 5.7e-6 and 3.4e-5 at two seeds,
measured when the net was ported), the hard mask equal where the soft value
is clear of 0.5, the updated statistics of both nets within 1e-5 of
max|stat|. The JAX
forwards are jitted.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocflow_torch.bench import perturb_batchnorm
from ocflow_torch.models import OCFlowNet, ocflownet_from_flax
from ocflow_torch.ops import resize_bilinear
from ocflow_tpu.models import ocflownet as joc
from ocflow_tpu.models import torch_convert as tc
from test_torch_ops import share_cores  # noqa: F401  (autouse)

EVAL_REL, STATS_REL = 1e-4, 1e-5
FP64_FLOW_REL, FP64_COMPLETED_REL = 1e-6, 1e-4
JAPPLY = jax.jit(joc.OCFlowNet().apply)
JTRAIN = jax.jit(functools.partial(joc.OCFlowNet().apply, train=True,
                                   mutable=["batch_stats"]))


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


def _seeded(seed):
    """The seeded port net and its flax variables (the JAX converters on
    each half, under the flax module names)."""
    model = OCFlowNet(generator=torch.Generator().manual_seed(seed))
    perturb_batchnorm(model, torch.Generator().manual_seed(seed + 100))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    halves = {name: convert({k[len(prefix) + 1:]: v for k, v in sd.items()
                             if k.startswith(prefix + ".")})
              for name, prefix, convert in (
                  ("SimpleFlowOccNet_0", "flow_occ", tc.convert_simple_flow_occ_net),
                  ("InpaintingNet_0", "inpaint", tc.convert_inpainting_net))}
    variables = {c: {name: v[c] for name, v in halves.items()}
                 for c in ("params", "batch_stats")}
    back = ocflownet_from_flax(variables)
    assert set(back) == set(sd)
    assert all(torch.equal(back[k].to(sd[k].dtype), sd[k]) for k in sd)
    return model, variables


def _soft_occ(model, x):
    """The forward and its soft occlusion ``sigmoid(10 logit)`` at full
    size, from the logit head through a forward hook."""
    seen = {}
    hook = model.flow_occ.predict_occ1.register_forward_hook(
        lambda m, i, o: seen.setdefault("logit", o))
    try:
        with torch.no_grad():
            out = model(x)
    finally:
        hook.remove()
    soft = torch.sigmoid(10.0 * resize_bilinear(seen["logit"], x.shape[1], x.shape[2]))
    return out, soft.permute(0, 2, 3, 1).numpy()


def _check(got, want, soft, flow_rel, completed_rel):
    flow, occ, completed = got
    assert flow.shape == (2, 64, 128, 2) and occ.shape == (2, 64, 128, 1)
    assert _rel(flow.numpy(), want[0]) <= flow_rel
    assert _rel(completed.numpy(), want[2]) <= completed_rel
    clear = np.abs(soft - 0.5) >= 1e-4
    assert clear.mean() > 0.99
    assert np.array_equal(occ.numpy()[clear], np.asarray(want[1])[clear])


@pytest.mark.parametrize("seed", [0, 1])
def test_ocflownet_eval_matches_jax(seed):
    model, variables = _seeded(seed)
    x = np.random.default_rng(seed).uniform(-1, 1, (2, 64, 128, 6)).astype(np.float32)
    want = JAPPLY(variables, jnp.asarray(x))
    got, soft = _soft_occ(model.eval(), torch.from_numpy(x))
    _check(got, want, soft, EVAL_REL, EVAL_REL)


def test_ocflownet_train_mode_fp64_matches_jax():
    model, variables = _seeded(3)
    x = np.random.default_rng(7).uniform(-1, 1, (2, 64, 128, 6))
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        want, upd = JTRAIN(v64, jnp.asarray(x))
        want, stats = _np_tree(want), _np_tree(upd["batch_stats"])
    model = model.double().train()
    got, soft = _soft_occ(model, torch.from_numpy(x))
    _check(got, want, soft, FP64_FLOW_REL, FP64_COMPLETED_REL)
    have = ocflownet_from_flax({"params": variables["params"], "batch_stats": stats})
    for k, v in have.items():
        if "running" in k:
            assert _rel(model.state_dict()[k].numpy(), v.numpy()) <= STATS_REL, k
