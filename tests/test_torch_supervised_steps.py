"""One supervised train step of the port == one step of ``ocflow_tpu``'s
``make_supervised_flow_step`` / ``make_supervised_occ_step`` /
``make_supervised_flow_occ_step``, on the CPU, fp32 at 2x64x128, on
SimpleFlowNet and FlowNet (flow, MSE), FlowOccNetCV ``pwoc`` and FlowOccNetC
(flow-occ, L1 + BCE) and OcclusionNetC (occ, focal BCE); and
``focal_bce_loss``.

Seeded port weights, with BatchNorm statistics and biases drawn from a
seed (the init starts them at the identity and zero), cross to flax through
the JAX package's converters; the batch is numpy from a seed. The JAX
state's optimizer hands back the raw gradient (an optax transform that
stores it and moves nothing), so both sides' gradients come straight from
their autodiff.

Bounds: the loss and every metric within 1e-5 relative; the updated
BatchNorm statistics within 1e-5 of max|statistic|; each parameter's
gradient, max-abs over its max|grad|, within ``GRAD_REL`` and the median
over the net's tensors within ``GRAD_MEDIAN``. A bias whose output reaches
the loss only through a train-mode BatchNorm (FPNUp's deconv in FlowNet;
SimpleFlowNet's inner flow heads, read by ProjUp's 1x1 conv and its
BatchNorm) has a zero gradient in exact arithmetic, rounding noise on
either side: it is held against the net's largest gradient instead.

The bounds come from an fp64 witness: the port's step in fp64, against
which both packages' fp32 steps were measured over seeds 0-2. pwoc and the
d=10 nets hold the summation-order bound, 1e-4 (measured at most 3.0e-5).
SimpleFlowNet's fifteen train-mode BatchNorms over few values (16 a channel
at its 2x4 level) carry fp32 rounding far: both fp32 steps lie 6.0e-3-1.9e-2
of max|grad| from the fp64 step in their worst tensor (medians 2.4e-3-5.6e-3),
and 4.0e-3-1.8e-2 from each other (medians 1.2e-3-5.6e-3); its bounds, 2e-2
and 6e-3, are just above those. FlowNet's fp32 steps at seeds 0 and 2 lie at
most 7.9e-5 from the fp64 step and 6.1e-5 from each other (medians 6.0e-6,
1.2e-5): 1e-4 and 2e-5. At seed 1 the JAX package's fp32 step reads 1.2e-2
on its context network's first conv, the port's 7.9e-5, and the JAX step
under ``jax_enable_x64`` 3.4e-6: the JAX package's fp32 rounding, not a
difference of the two nets. ``tests/test_torch_supervised_steps_fp64.py`` holds
both packages in fp64 on the seeded init (biases zero, BatchNorm the
identity) within 1e-5 of max|grad| (measured at most 8.4e-7: the JAX
package's warp keeps fp32 coordinates under x64, ``ocflow_tpu/ops/warp.py``).
``train_step`` leaves the model in train mode, ``eval_step`` in eval mode
(the JAX eval step runs ``train=False``) and updates nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ocflow_torch import losses as tlosses
from ocflow_torch.bench import perturb_batchnorm
from ocflow_torch.models import (FlowNet, FlowOccNetC, FlowOccNetCV, OcclusionNetC,
                                 SimpleFlowNet)
from ocflow_torch.train import (TrainState, create_train_state,
                                make_supervised_flow_occ_step, make_supervised_flow_step,
                                make_supervised_occ_step)
from ocflow_tpu.losses import classification as jcls
from ocflow_tpu.models import flow_net as jfn
from ocflow_tpu.models import flow_occ_nets as jfon
from ocflow_tpu.models import occlusion_nets as jocc
from ocflow_tpu.models import simple_flow_net as jsfn
from ocflow_tpu.models import torch_convert as tc
from ocflow_tpu.train import TrainState as JTrainState
from ocflow_tpu.train import steps as jsteps
from test_torch_ops import share_cores  # noqa: F401  (autouse)

STEPS = {"flow": (make_supervised_flow_step, jsteps.make_supervised_flow_step),
         "occ": (make_supervised_occ_step, jsteps.make_supervised_occ_step),
         "flow-occ": (make_supervised_flow_occ_step, jsteps.make_supervised_flow_occ_step)}
CASES = {
    "simple": ("flow", SimpleFlowNet, jsfn.SimpleFlowNet, tc.convert_simpleflownet),
    "flownet": ("flow", FlowNet, jfn.FlowNet, tc.convert_flownet_fpn),
    "pwoc": ("flow-occ", FlowOccNetCV, jfon.FlowOccNetCV, tc.convert_flow_occ_net_cv),
}
# the d=10 nets, in tests/test_torch_supervised_steps_d10.py (the Pallas
# kernel in interpret mode takes most of their time)
D10_CASES = {
    "flowoccnetc": ("flow-occ", FlowOccNetC, jfon.FlowOccNetC, tc.convert_flow_occ_net_c),
    "occnetc": ("occ", OcclusionNetC, jocc.OcclusionNetC, tc.convert_occlusion_net_c),
}

GRAD_REL = {"simple": 2e-2, "flownet": 1e-4, "pwoc": 1e-4, "flowoccnetc": 1e-4,
            "occnetc": 1e-4}
GRAD_MEDIAN = {"simple": 6e-3, "flownet": 2e-5, "pwoc": 1e-4, "flowoccnetc": 1e-4,
               "occnetc": 1e-4}

# the JAX optimizer: its state becomes the raw gradient, the params stay
CAPTURE = optax.GradientTransformation(
    init=lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
    update=lambda grads, state, params=None: (
        jax.tree_util.tree_map(jnp.zeros_like, grads), grads))


def _batch(seed=4, b=2, h=64, w=128):
    rng = np.random.default_rng(seed)
    return {"images": rng.uniform(-1, 1, (b, h, w, 6)).astype(np.float32),
            "flow": (rng.normal(size=(b, h, w, 2)) * 3).astype(np.float32),
            "occ": (rng.uniform(size=(b, h, w, 1)) > 0.8).astype(np.float32)}


def _copy(convert, model, grads=False):
    """flax variables of ``model`` (or of its gradients), copied out of the
    tensors (the converters return views)."""
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    if grads:
        sd.update({k: p.grad.clone() for k, p in model.named_parameters()})
    return convert(sd)


def _perturbed(port_cls, seed):
    """The seeded net with its BatchNorm statistics and its biases drawn
    from the seed too (the seeded init starts them at the identity and at
    zero; a zero bias leaves pre-activations that are exactly zero but for
    rounding where a conv reads only padding, and LeakyReLU's slope there
    would follow the summation order)."""
    model = port_cls(generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 100)
    perturb_batchnorm(model, gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)) and m.bias is not None:
                m.bias.copy_(torch.rand(m.bias.shape, generator=gen) * 0.2 - 0.1)
    return model


def _step(port_cls, jax_cls, convert, network_type, seed=0, fp64=False):
    """One train step of both packages from the same weights and batch: in
    fp32 on :func:`_perturbed` weights, or (``fp64``) in fp64 on the seeded
    init, the JAX step under ``jax_enable_x64``."""
    if fp64:
        model = port_cls(generator=torch.Generator().manual_seed(seed))
    else:
        model = _perturbed(port_cls, seed)
    variables = _copy(convert, model)
    batch = _batch()
    jdt = jnp.float64 if fp64 else jnp.float32
    port_factory, jax_factory = STEPS[network_type]
    with jax.enable_x64(fp64):
        cast = lambda tree: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), tree)
        stats = variables.get("batch_stats")
        jstate = JTrainState.create(apply_fn=jax_cls().apply, params=cast(variables["params"]),
                                    tx=CAPTURE, batch_stats=stats and cast(stats))
        jtrain, _ = jax_factory({})
        jstate, jmetrics = jtrain(jstate, {k: jnp.asarray(v, jdt) for k, v in batch.items()})

    if fp64:
        model = model.double()
        state = TrainState(model, torch.optim.Adam(model.parameters(), lr=1e-4))
    else:
        state = create_train_state(model, 1e-4, device="cpu")
    train_step, eval_step = port_factory({})
    dt = torch.float64 if fp64 else torch.float32
    state, metrics = train_step(state, {k: torch.from_numpy(v).to(dt)
                                        for k, v in batch.items()})
    assert state.model.training and state.step == 1
    return model, state, metrics, jstate, jmetrics, eval_step, batch


def _bn_fed(key, name):
    """A bias whose output reaches the loss only through a train-mode
    BatchNorm: zero gradient in exact arithmetic."""
    return name.endswith("['ConvTranspose_0']['bias']") and "FPNUp" in name or (
        key == "simple" and name.endswith("['Conv_0']['bias']")
        and "PredictFlowStack_5" not in name and "PredictFlowStack" in name)


def _grad_errors(key, convert, model, jstate):
    """Per flax parameter path: max|port - jax| over max|jax| of its
    gradient (a :func:`_bn_fed` bias over the net's largest gradient)."""
    got = dict(jax.tree_util.tree_leaves_with_path(
        _copy(convert, model, grads=True)["params"]))
    want = jax.tree_util.tree_leaves_with_path(jstate.opt_state)
    assert len(got) == len(want)
    want = [(path, np.asarray(w, np.float64)) for path, w in want]
    top = max(float(np.abs(w).max()) for _, w in want)
    errs = {}
    for path, w in want:
        name = jax.tree_util.keystr(path)
        scale = top if _bn_fed(key, name) else np.abs(w).max()
        errs[name] = np.abs(np.asarray(got[path], np.float64) - w).max() / scale
    return errs


@pytest.mark.parametrize("key", CASES)
def test_supervised_step_matches_jax(key):
    check_step(key, CASES[key])


def check_step(key, case):
    """One step of the net ``case`` against the JAX step, as the module
    docstring states."""
    network_type, port_cls, jax_cls, convert = case
    model, state, metrics, jstate, jmetrics, eval_step, batch = _step(
        port_cls, jax_cls, convert, network_type)
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        assert abs(metrics[k].item() - float(v)) <= 1e-5 * abs(float(v)), k

    errs = _grad_errors(key, convert, model, jstate)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_REL[key], (worst, errs[worst])
    assert np.median(list(errs.values())) <= GRAD_MEDIAN[key]

    if jstate.batch_stats:
        have = dict(jax.tree_util.tree_leaves_with_path(_copy(convert, model)["batch_stats"]))
        for path, w in jax.tree_util.tree_leaves_with_path(jstate.batch_stats):
            w = np.asarray(w)
            assert np.abs(have[path] - w).max() <= 1e-5 * np.abs(w).max(), path

    # the eval step: eval mode, the running statistics, no update
    before = {k: v.clone() for k, v in model.state_dict().items()}
    out = eval_step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert not state.model.training and set(out) == set(metrics)
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in before.items())


@pytest.mark.parametrize("gamma", [2.0, 0.5])
def test_focal_bce_loss_matches_jax(gamma):
    rng = np.random.default_rng(int(gamma * 10))
    pred = rng.uniform(size=(2, 1, 16, 24)).astype(np.float32)
    pred[0, 0, 0], pred[0, 0, 1] = 0.0, 1.0  # the clip at eps and 1 - eps
    target = (rng.uniform(size=pred.shape) > 0.7).astype(np.float32)
    ref = float(jcls.focal_bce_loss(jnp.asarray(pred), jnp.asarray(target), gamma=gamma))
    got = tlosses.focal_bce_loss(torch.from_numpy(pred), torch.from_numpy(target), gamma=gamma)
    assert abs(got.item() - ref) <= 1e-6 * abs(ref)
