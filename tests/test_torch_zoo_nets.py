"""The nets that launch no kernel of the repository (FlowNetS, OcclusionNetS,
FlowOccNetS, SimpleOcclusionNet, SimpleFlowOccNet, EFlowNet, EFlowNet2) ==
the JAX modules, at equal weights on the CPU, and their weight bridges.

Seeded port weights, BatchNorm statistics perturbed from a seed (the seeded
init starts BatchNorm at the identity), mapped to flax variables by the JAX
package's converters through :func:`to_flax`; numpy inputs from a seed,
2x64x128.

- eval forward (``train=False``): max-abs <= 1e-4 of max|JAX output| per
  output (measured at most 7.6e-7);
- train-mode forward (``train=True, mutable=["batch_stats"]``): each
  output within 1e-4 of max|output| and every updated BatchNorm statistic
  within 1e-5 of max|statistic|. The ENets are held against the flax module
  under ``jax_enable_x64`` in fp64, with their dropout off on both sides
  (``nn.intercept_methods`` returns flax ``Dropout``'s input; the port's
  ``Dropout2d`` modules in eval mode): the JAX package's own fp32
  train-mode forward lies 4.5e-5-1.6e-4 of max|flow| from its fp64 one over
  three seeds (the port's fp32 1.5e-5-3.6e-5), its hundred train-mode
  BatchNorms carrying fp32 rounding far. At 64x64 the FlowNetS trunk's
  conv6_1 normalizes 2 values a channel and the JAX package's fp32 running
  mean there reads 1.1e-5-1.7e-5 from fp64 (the port's 2.8e-6-7.4e-6);
  at 64x128 both read about 1e-6;
- the port's ENet dropout drops whole channels in train mode, by
  ``Dropout2d``, as flax's ``Dropout(broadcast_dims=(1, 2))``;
- the ENets' PReLU slopes after the seeded init are flax's: 0.25 per
  channel in the initial block, one scalar 0.01 per bottleneck activation;
- the flax -> port bridges (``models.convert``) and the JAX package's
  converters (port -> flax) round-trip exactly.

The FlowNetS family's up-deconvs carry a bias, as the JAX modules' do; the
reference torch nets have none there, so :func:`to_flax` hands the JAX
converters a ``state_dict`` without those biases and puts them in the tree
where the converters put zeros.
"""

import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocflow_torch.bench import perturb_batchnorm
from ocflow_torch.models import (EFlowNet, EFlowNet2, FlowNetS, FlowNetSFamily, FlowOccNetS,
                                 OcclusionNetS, SimpleFlowOccNet, SimpleOcclusionNet,
                                 eflownet_from_flax, flownets_from_flax, flowoccnets_from_flax,
                                 occnets_from_flax, simpleflowoccnet_from_flax,
                                 simpleoccnet_from_flax)
from ocflow_tpu.models import efficient_flow_net as jefn
from ocflow_tpu.models import flow_net_s as jfns
from ocflow_tpu.models import flow_occ_nets as jfon
from ocflow_tpu.models import occlusion_nets as jocc
from ocflow_tpu.models import torch_convert as tc
from test_torch_ops import share_cores  # noqa: F401  (autouse)

NETS = {
    "flownets": (FlowNetS, jfns.FlowNetS, tc.convert_flownets, flownets_from_flax),
    "occnets": (OcclusionNetS, jocc.OcclusionNetS, tc.convert_occlusion_net_s,
                occnets_from_flax),
    "flowoccnets": (FlowOccNetS, jfon.FlowOccNetS, tc.convert_flow_occ_net_s,
                    flowoccnets_from_flax),
    "occ_simple": (SimpleOcclusionNet, jocc.SimpleOcclusionNet,
                   tc.convert_simple_occlusion_net, simpleoccnet_from_flax),
    "flow_occ_simple": (SimpleFlowOccNet, jfon.SimpleFlowOccNet,
                        tc.convert_simple_flow_occ_net, simpleflowoccnet_from_flax),
    "eflownet": (EFlowNet, jefn.EFlowNet, tc.convert_eflownet, eflownet_from_flax),
    "eflownet2": (EFlowNet2, jefn.EFlowNet2, tc.convert_eflownet2, eflownet_from_flax),
}
ENETS = ("eflownet", "eflownet2")  # their tests: tests/test_torch_enets.py
FIVE = tuple(k for k in NETS if k not in ENETS)
_UP_BIAS = re.compile(r"upsampled_(flow|occ)(\d)_to_\d\.bias")


def to_flax(port_cls, convert, sd):
    """flax variables of the port ``state_dict`` ``sd`` through the JAX
    package's converter ``convert``; a FlowNetS-family net's up-deconv
    biases go where the converter puts zeros (``Deconv_k``, k = (heads + 1)
    * level index + head index, the flax creation order)."""
    sd = dict(sd)
    ups = {}
    if issubclass(port_cls, FlowNetSFamily):
        ups = {k: sd.pop(k) for k in list(sd) if _UP_BIAS.fullmatch(k)}
    variables = convert(sd)
    for name, bias in ups.items():
        head, lvl = _UP_BIAS.fullmatch(name).groups()
        k = (len(port_cls.HEADS) + 1) * (6, 5, 4, 3).index(int(lvl)) + port_cls.HEADS.index(head)
        node = variables["params"][f"Deconv_{k}"]["ConvTranspose_0"]
        assert not np.any(node["bias"])
        node["bias"] = np.asarray(bias)
    return variables


def _variables(key, model):
    """flax variables of ``model``'s weights, copied (the converters return
    numpy views, which a train-mode forward updates in place)."""
    port_cls, _, convert, _ = NETS[key]
    return to_flax(port_cls, convert, {k: v.clone() for k, v in model.state_dict().items()})


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _seeded(key, seed=0):
    model = NETS[key][0](generator=torch.Generator().manual_seed(seed))
    perturb_batchnorm(model, torch.Generator().manual_seed(seed + 100))
    return model


def _input(seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, (2, 64, 128, 6)).astype(np.float32)


def _no_dropout(next_fun, args, kwargs, context):
    """A flax method interceptor: ``Dropout`` returns its input."""
    if isinstance(context.module, fnn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


@pytest.mark.parametrize("key", FIVE)
def test_forward_matches_jax(key):
    check_forward(key)


@pytest.mark.parametrize("key", FIVE)
def test_train_mode_forward_and_batch_stats_match_jax(key):
    check_train_mode(key)


@pytest.mark.parametrize("key", FIVE)
def test_from_flax_round_trip(key):
    check_round_trip(key)


def check_forward(key):
    """The eval forward against the JAX module's, as the module docstring
    states."""
    port_cls, jax_cls, _, _ = NETS[key]
    model = _seeded(key).eval()
    variables = _variables(key, model)
    x = _input()
    ref = _tuple(jax.jit(lambda v, a: jax_cls().apply(v, a, train=False))(
        variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _tuple(model(torch.from_numpy(x)))
    assert len(got) == len(ref) == (2 if "flowocc" in key or key == "flow_occ_simple" else 1)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert g.shape == r.shape and g.shape[:3] == (2, 64, 128) and g.dtype == torch.float32
        assert np.abs(g.numpy() - r).max() <= 1e-4 * np.abs(r).max()
    if key.startswith("occ") or len(got) == 2:
        occ = got[-1].numpy()
        assert occ.shape[-1] == 1 and occ.min() >= 0 and occ.max() <= 1
    if key == "flow_occ_simple":  # hardened by the STE
        assert set(np.unique(got[1].numpy())) <= {0.0, 1.0}


def check_train_mode(key):
    """The train-mode forward and the updated statistics against the JAX
    module's, as the module docstring states."""
    port_cls, jax_cls, _, _ = NETS[key]
    model = _seeded(key, seed=2).train()
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout2d):
            m.eval()
    variables = _variables(key, model)
    x = _input(seed=3)
    fp64 = key in ENETS
    with jax.enable_x64(fp64), fnn.intercept_methods(_no_dropout):
        dt = jnp.float64 if fp64 else jnp.float32
        cast = lambda tree: jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), tree)
        ref, updates = jax.jit(lambda v, a: jax_cls().apply(v, a, train=True,
                                                            mutable=["batch_stats"]))(
            cast(variables), jnp.asarray(x, dt))
        ref = [np.asarray(r, np.float64) for r in _tuple(ref)]
        want = [(p, np.asarray(w, np.float64))
                for p, w in jax.tree_util.tree_leaves_with_path(updates["batch_stats"])]
    with torch.no_grad():
        got = _tuple(model(torch.from_numpy(x)))
    for g, r in zip(got, ref):
        assert np.abs(g.numpy() - r).max() <= 1e-4 * np.abs(r).max()
    have = dict(jax.tree_util.tree_leaves_with_path(_variables(key, model)["batch_stats"]))
    before = dict(jax.tree_util.tree_leaves_with_path(variables["batch_stats"]))
    assert set(have) == {p for p, _ in want} and len(want) > 0
    for path, w in want:
        assert np.abs(have[path] - w).max() <= 1e-5 * np.abs(w).max(), path
        assert not np.array_equal(have[path], before[path])  # the statistics moved


def check_round_trip(key):
    """flax variables -> port state_dict (loads strictly into the module)
    -> the JAX package's converter -> identical trees."""
    port_cls, jax_cls, convert, from_flax = NETS[key]
    shapes = jax.eval_shape(jax_cls().init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 6)))
    rng = np.random.default_rng(7)

    def fill(path, s):
        leaf = rng.normal(size=s.shape).astype(np.float32)
        return np.abs(leaf) + 0.5 if path[-1].key == "var" else leaf

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    sd = from_flax(variables)
    port_cls().load_state_dict(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(to_flax(port_cls, convert, sd)))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)

