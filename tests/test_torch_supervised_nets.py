"""The d=4 flow and flow+occlusion nets and SimpleFlowNet (SimpleFlowNet,
FlowNet, FlowOccNetCV ``pwoc``, FlowOccNetCV2 ``pwoc2``, FlowOccNet
``flowoccnet``) == the JAX modules, at equal weights on the CPU.

Seeded port weights, BatchNorm statistics perturbed from a seed (the seeded
init starts BatchNorm at the identity), mapped to flax variables by the JAX
package's converters (``convert_simpleflownet``, ``convert_flownet_fpn``,
``convert_flow_occ_net_cv``, ``convert_flow_occ_net_cv2``,
``convert_flow_occ_net_fpn``); numpy inputs from a seed, 2x64x128.

- eval forward (``train=False``): max-abs <= 1e-4 of max|JAX output| per
  output, as the FlowNetC family is held (summation order only);
- train-mode forward (``train=True, mutable=["batch_stats"]``): outputs
  within 1e-5 of max|output| and every updated BatchNorm statistic within
  1e-5 (relative to max|statistic|). SimpleFlowNet's outputs are held at
  5e-5: its fifteen train-mode BatchNorms, at the 2x4 level over 16 values
  a channel, carry fp32 rounding far; both packages' fp32 outputs lie
  7e-6 (port) and 1.3e-5 (JAX) of max|output| from the port's fp64 run,
  1.0e-5-2.4e-5 from each other over three seeds and two sizes;
- the flax -> port weight bridges (``models.convert``) round-trip through
  the JAX converters exactly (the registry's keys:
  ``tests/test_torch_flownetc.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocflow_torch.bench import perturb_batchnorm
from ocflow_torch.kernels import cost_volume as cv_mod
from ocflow_torch.models import (FlowNet, FlowOccNet, FlowOccNetCV, FlowOccNetCV2,
                                 SimpleFlowNet, flownet_from_flax, flowoccnet_from_flax,
                                 flowoccnetcv2_from_flax, flowoccnetcv_from_flax,
                                 simpleflownet_from_flax)
from ocflow_tpu.models import flow_net as jfn
from ocflow_tpu.models import flow_occ_nets as jfon
from ocflow_tpu.models import simple_flow_net as jsfn
from ocflow_tpu.models import torch_convert as tc
from test_torch_ops import share_cores  # noqa: F401  (autouse)

NETS = {
    "simple": (SimpleFlowNet, jsfn.SimpleFlowNet, tc.convert_simpleflownet,
               simpleflownet_from_flax),
    "flownet": (FlowNet, jfn.FlowNet, tc.convert_flownet_fpn, flownet_from_flax),
    "pwoc": (FlowOccNetCV, jfon.FlowOccNetCV, tc.convert_flow_occ_net_cv,
             flowoccnetcv_from_flax),
    "pwoc2": (FlowOccNetCV2, jfon.FlowOccNetCV2, tc.convert_flow_occ_net_cv2,
              flowoccnetcv2_from_flax),
    "flowoccnet": (FlowOccNet, jfon.FlowOccNet, tc.convert_flow_occ_net_fpn,
                   flowoccnet_from_flax),
}
BN_NETS = ("simple", "flownet", "flowoccnet")
TRAIN_TOL = {"simple": 5e-5, "flownet": 1e-5, "flowoccnet": 1e-5}


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _seeded(key, seed=0):
    model = NETS[key][0](generator=torch.Generator().manual_seed(seed))
    perturb_batchnorm(model, torch.Generator().manual_seed(seed + 100))
    return model


def _variables(convert, model):
    """flax variables of ``model``'s weights, copied: the converters return
    numpy views of the tensors, which a train-mode forward updates in
    place (and JAX may read them after its asynchronous dispatch)."""
    return convert({k: v.clone() for k, v in model.state_dict().items()})


def _input(seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, (2, 64, 128, 6)).astype(np.float32)


@pytest.mark.parametrize("key", NETS)
def test_forward_matches_jax(key):
    port_cls, jax_cls, convert, _ = NETS[key]
    model = _seeded(key).eval()
    variables = _variables(convert, model)
    x = _input()
    ref = _tuple(jax.jit(lambda v, a: jax_cls().apply(v, a, train=False))(
        variables, jnp.asarray(x)))
    cv_mod.cost_volume.launches = 0
    with torch.no_grad():
        got = _tuple(model(torch.from_numpy(x)))
    assert cv_mod.cost_volume.launches == 0  # CPU tensors: the plain op
    assert len(got) == len(ref) == (1 if key in ("simple", "flownet") else 2)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape and g.shape[:3] == (2, 64, 128) and g.dtype == torch.float32
        assert np.abs(g.numpy() - r).max() <= 1e-4 * np.abs(r).max()
    if len(got) == 2:
        occ = got[1].numpy()
        assert occ.shape[-1] == 1 and occ.min() >= 0 and occ.max() <= 1


@pytest.mark.parametrize("key", BN_NETS)
def test_train_mode_forward_and_batch_stats_match_jax(key):
    port_cls, jax_cls, convert, _ = NETS[key]
    model = _seeded(key, seed=2).train()
    variables = _variables(convert, model)
    x = _input(seed=3)
    ref, updates = jax.jit(lambda v, a: jax_cls().apply(v, a, train=True,
                                                        mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = _tuple(model(torch.from_numpy(x)))
    for g, r in zip(got, _tuple(ref)):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= TRAIN_TOL[key] * np.abs(r).max()
    after = convert(model.state_dict())["batch_stats"]
    want = dict(jax.tree_util.tree_leaves_with_path(updates["batch_stats"]))
    have = dict(jax.tree_util.tree_leaves_with_path(after))
    assert set(want) == set(have) and len(want) > 0
    before = dict(jax.tree_util.tree_leaves_with_path(variables["batch_stats"]))
    for path, w in want.items():
        w = np.asarray(w)
        assert np.abs(have[path] - w).max() <= 1e-5 * np.abs(w).max(), path
        assert not np.array_equal(w, before[path])  # the statistics moved


@pytest.mark.parametrize("key", NETS)
def test_from_flax_round_trip(key):
    """flax variables -> port state_dict (loads strictly into the module)
    -> the JAX package's converter -> identical trees."""
    port_cls, jax_cls, convert, from_flax = NETS[key]
    shapes = jax.eval_shape(jax_cls().init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 6)))
    rng = np.random.default_rng(7)

    def fill(path, s):
        leaf = rng.normal(size=s.shape).astype(np.float32)
        return np.abs(leaf) + 0.5 if path[-1].key == "var" else leaf

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    assert ("batch_stats" in variables) == (key in BN_NETS)
    sd = from_flax(variables if key in BN_NETS else variables["params"])
    port_cls().load_state_dict(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(convert(sd)))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)
