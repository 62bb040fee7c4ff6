"""FlowNetCV built with displacement 12 (``model: pwc``, ``displacement: 12``
in the supervised CLI's config) == the JAX package's ``FlowNetCV`` with the
same displacement, on the CPU at 2x3x64x128, fp32.

The port reaches the cost volume past the tuned kernels' d = 10 here, on
the card the general kernels of ``csrc/cost_volume_any.cu`` (five levels,
forward and backward); on the CPU their plain versions. The JAX package
takes its XLA cost volume at d = 12 (its Pallas block does not fit).

The port's seeded weights with every bias drawn from a seed (a zero bias
leaves pre-activations exactly zero where a conv reads only padding, and
LeakyReLU's slope there would follow the summation order) go to flax
through the JAX package's ``convert_flownetcv`` and come back to the port by
``flownetcv_from_flax``. One supervised flow step of the JAX package
(``make_supervised_flow_step``: MSE against the batch's flow) runs once; a
callback in its ``apply_fn`` keeps the forward it computed. Bounds:

- the forward, full and quarter resolution, within 1e-4 of max|out| (read
  1.2e-6);
- the step's loss within 1e-5 relative (read 1.2e-6); the gradient, per
  tensor max-abs over its max|grad|, within 1e-4 of the JAX package's, and
  each of the two fp32 steps within 1e-4 of the port's fp64 step, the
  witness (read: port against JAX 5.1e-5, port 5.3e-5 and JAX 6.0e-5
  against fp64, all at an up-deconv's bias; medians 3e-6-9e-6).

The JAX step's XLA compile (625 shifts at each of five levels, forward and
backward, unrolled) takes most of this file's time, ~100 s on a cold cache.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ocflow_torch.models import FlowNetCV, flownetcv_from_flax
from ocflow_torch.train import TrainState, create_train_state, make_supervised_flow_step
from ocflow_tpu.models import pwc_net as jpwc
from ocflow_tpu.models.torch_convert import convert_flownetcv
from ocflow_tpu.train import TrainState as JTrainState
from ocflow_tpu.train import steps as jsteps
from test_torch_ops import share_cores  # noqa: F401  (autouse)

D = 12
SHAPE = (2, 64, 128)
FWD_REL, LOSS_REL, GRAD_REL = 1e-4, 1e-5, 1e-4

# the JAX optimizer: its state becomes the raw gradient, the params stay
CAPTURE = optax.GradientTransformation(
    init=lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
    update=lambda grads, state, params=None: (
        jax.tree_util.tree_map(jnp.zeros_like, grads), grads))


@pytest.fixture(scope="module")
def case():
    """(flax params, the batch, the JAX step's forward, state and metrics)."""
    rng = np.random.default_rng(12)
    b, h, w = SHAPE
    batch = {"images": rng.uniform(-1, 1, (b, h, w, 6)).astype(np.float32),
             "flow": (rng.normal(size=(b, h, w, 2)) * 3).astype(np.float32)}
    seeded = FlowNetCV(displacement=D, generator=torch.Generator().manual_seed(0))
    params = convert_flownetcv({k: v.clone() for k, v in seeded.state_dict().items()})["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.uniform(-0.1, 0.1, a.shape).astype(np.float32)
                         if jax.tree_util.keystr(path).endswith("['bias']") else np.asarray(a)),
        params)

    net, seen = jpwc.FlowNetCV(displacement=D), {}

    def apply_fn(variables, x, **kwargs):
        out = net.apply(variables, x, **kwargs)
        jax.debug.callback(lambda full, quarter: seen.update(
            full=np.asarray(full), quarter=np.asarray(quarter)), *out)
        return out

    jstate = JTrainState.create(apply_fn=apply_fn, params=params, tx=CAPTURE)
    jtrain, _ = jsteps.make_supervised_flow_step({})
    jstate, jmetrics = jtrain(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    jax.block_until_ready(jmetrics)
    return params, batch, (seen["full"], seen["quarter"]), jstate, jmetrics


def _port(params, dtype=torch.float32):
    model = FlowNetCV(displacement=D)
    model.load_state_dict(flownetcv_from_flax(params))
    return model.to(dtype)


def test_forward_matches_jax(case):
    params, batch, want, _, _ = case
    with torch.no_grad():
        got = _port(params)(torch.from_numpy(batch["images"]))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= FWD_REL * np.abs(w).max()


def _grads(model):
    return {n: p.grad.detach().double() for n, p in model.named_parameters()}


def test_supervised_step_matches_jax(case):
    params, batch, _, jstate, jmetrics = case
    jgrads = {n: t.double() for n, t in flownetcv_from_flax(jstate.opt_state).items()}
    train_step, _ = make_supervised_flow_step({"model": "pwc", "compute_dtype": "float32"})
    state, metrics = train_step(create_train_state(_port(params), 1e-4, device="cpu"),
                                {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = _grads(state.model)
    exact = _port(params, torch.float64)
    train_step(TrainState(exact, torch.optim.Adam(exact.parameters(), lr=1e-4)),
               {k: torch.from_numpy(v).double() for k, v in batch.items()})
    witness = _grads(exact)

    loss = float(jmetrics["loss"])
    assert abs(metrics["loss"].item() - loss) <= LOSS_REL * abs(loss)
    assert set(grads) == set(jgrads) == set(witness)

    def worst(got, ref):
        return max(((got[n] - r).abs().max() / r.abs().max().clamp_min(1e-300)).item()
                   for n, r in ref.items())

    assert worst(grads, witness) <= GRAD_REL
    assert worst(jgrads, witness) <= GRAD_REL
    assert worst(grads, jgrads) <= GRAD_REL
