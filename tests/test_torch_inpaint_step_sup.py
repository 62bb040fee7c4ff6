"""One supervised inpainting train step of the port against
``ocflow_tpu.train.steps_inpainting.make_supervised_inpainting_step``, on
the CPU at 2x64x128 (InpaintingNet; frame 2 warped by the ground-truth flow
with ``align_corners=False``, the occluded region zeroed and completed, the
masked L1 against frame 1); the eval step. The helpers serve
``tests/test_torch_inpaint_step_stage.py`` too.

Seeded port weights (running statistics perturbed from a seed) cross to
flax through the JAX package's ``convert_inpainting_net``. The port's warp
rounds ``align_corners=False``'s rescale ``x * W / (W - 1) - 0.5`` once, as
the JAX package's jitted warp does (XLA's fused multiply-add), and sums an
fp64 image's taps in fp64; it is held against the JAX warp to 1e-12 in
fp64. Before it did (ROADMAP §C5, fixed), the warped frame differed in its
last bits, and InpaintingNet's train-mode BatchNorms carried that to the
fp64 steps' gradients, 2.3e-2-6.1e-2 apart over seeds 0-2; the steps below
run the port's own warp. The JAX state's
optimizer in the gradient check hands back the raw gradient (an optax
transform that stores it and moves nothing); the Adam check runs
``optax.adam`` against ``torch.optim.Adam``.

In fp64 (both packages, ``jax_enable_x64``): the loss and every metric
within 1e-5 relative, each parameter's gradient within 1e-4 of its
max|grad|, the updated BatchNorm statistics within 1e-5 of max|stat| and
the parameters after one Adam step within 1e-4 of max|param|. In fp32 the
loss, the metrics and the statistics are held the same way; the gradients
are not held at 1e-4 per tensor: the net's twelve train-mode BatchNorms,
the deepest over 4 values a channel at 1x2, carry fp32 rounding far, as the
module docstring of ``tests/test_torch_inpaint_nets.py`` measures for the
forward. The fp32 gradients are held on the whole gradient (relative L2
within ``FP32_GRAD_L2``) and per tensor within ``FP32_GRAD_REL``: over seeds
0-2 (measured on the CPU when the step was ported), worst tensor and whole
gradient, the port's fp32 step read 0.020-0.066 and 0.008-0.024 from the
JAX package's fp32 step in the supervised step, 0.017-0.098 and
0.010-0.014 in the stage step, while each fp32 step lies as far from the
fp64 step (the port's 0.020-0.10, the JAX package's 0.016-0.096), and the
two fp64 steps lie within 1e-11 of each other.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ocflow_torch.bench import perturb_batchnorm
from ocflow_torch.models import InpaintingNet
from ocflow_torch.ops import warp
from ocflow_torch.train import (TrainState, create_train_state, make_inpainting_stage_step,
                                make_supervised_inpainting_step)
from ocflow_tpu.models import inpainting_net as jinp
from ocflow_tpu.models import torch_convert as tc
from ocflow_tpu.train import TrainState as JTrainState
from ocflow_tpu.train import steps_inpainting as jsteps
from test_torch_ops import share_cores  # noqa: F401  (autouse)

METRIC_REL, GRAD_REL, STATS_REL, PARAM_REL = 1e-5, 1e-4, 1e-5, 1e-4
FP32_GRAD_REL, FP32_GRAD_L2 = 0.12, 3e-2
LR = 1e-3

STEPS = {"supervised": (make_supervised_inpainting_step,
                        jsteps.make_supervised_inpainting_step),
         "stage": (make_inpainting_stage_step, jsteps.make_inpainting_stage_step)}

# the JAX optimizer of the gradient check: its state becomes the raw
# gradient, the params stay
CAPTURE = optax.GradientTransformation(
    init=lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
    update=lambda grads, state, params=None: (
        jax.tree_util.tree_map(jnp.zeros_like, grads), grads))


def make_batch(kind, seed=4, b=2, h=64, w=128):
    rng = np.random.default_rng(seed)
    occ = (rng.uniform(size=(b, h, w, 1)) > 0.7).astype(np.float32)
    if kind == "supervised":
        return {"images": rng.uniform(-1, 1, (b, h, w, 6)).astype(np.float32),
                "flow": (rng.normal(size=(b, h, w, 2)) * 3).astype(np.float32), "occ": occ}
    return {"image": rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32), "occ": occ}


def _seeded(seed):
    model = InpaintingNet(generator=torch.Generator().manual_seed(seed))
    perturb_batchnorm(model, torch.Generator().manual_seed(seed + 100))
    return model


def _flax(model, grads=False):
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    if grads:
        sd.update({k: p.grad.clone() for k, p in model.named_parameters()})
    return tc.convert_inpainting_net(sd)


def run_steps(kind, seed=0, fp64=False, adam=False):
    """One train step of both packages from the same weights and batch.
    Returns the port's model, state and metrics, the JAX state and metrics,
    the port's eval step and the batch."""
    model = _seeded(seed)
    variables = _flax(model)
    batch = make_batch(kind)
    jdt, dt = (jnp.float64, torch.float64) if fp64 else (jnp.float32, torch.float32)
    port_factory, jax_factory = STEPS[kind]
    hparams = {"loss_type": "pixel-wise"}
    with jax.enable_x64(fp64):
        cast = functools.partial(jax.tree_util.tree_map, lambda a: jnp.asarray(a, jdt))
        jstate = JTrainState.create(
            apply_fn=jinp.InpaintingNet().apply, params=cast(variables["params"]),
            tx=optax.adam(LR) if adam else CAPTURE,
            batch_stats=cast(variables["batch_stats"]))
        jtrain, _ = jax_factory(hparams)
        jstate, jmetrics = jtrain(jstate, {k: jnp.asarray(v, jdt) for k, v in batch.items()})
        jmetrics = {k: float(v) for k, v in jmetrics.items()}
    if fp64:
        model = model.double()
        state = TrainState(model, torch.optim.Adam(model.parameters(), lr=LR))
    else:
        state = create_train_state(model, LR, device="cpu")
    train_step, eval_step = port_factory(hparams)
    state, metrics = train_step(state, {k: torch.from_numpy(v).to(dt) for k, v in batch.items()})
    assert state.model.training and state.step == 1
    return model, state, metrics, jstate, jmetrics, eval_step, batch


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _per_tensor(got, want):
    return {k: np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-300)
            for k, w in want.items()}


def check_step(kind, fp64, seed=0):
    """The loss, metrics, gradients and updated statistics of one step, as
    the module docstring states; the eval step on the stepped state."""
    model, state, metrics, jstate, jmetrics, eval_step, batch = run_steps(
        kind, seed, fp64)
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        assert abs(metrics[k].item() - v) <= METRIC_REL * abs(v), k
    got = _leaves(_flax(model, grads=True)["params"])
    want = _leaves(jstate.opt_state)
    assert set(got) == set(want)
    errs = _per_tensor(got, want)
    worst = max(errs, key=errs.get)
    if fp64:
        assert errs[worst] <= GRAD_REL, (worst, errs[worst])
    else:
        assert errs[worst] <= FP32_GRAD_REL, (worst, errs[worst])
        num = sum(((got[k] - w) ** 2).sum() for k, w in want.items())
        den = sum((w ** 2).sum() for w in want.values())
        assert (num / den) ** 0.5 <= FP32_GRAD_L2
    have = _leaves(_flax(model)["batch_stats"])
    for k, w in _leaves(jstate.batch_stats).items():
        assert np.abs(have[k] - w).max() <= STATS_REL * np.abs(w).max(), k

    # the eval step: eval mode, the running statistics, nothing updated
    dt = torch.float64 if fp64 else torch.float32
    before = {k: v.clone() for k, v in model.state_dict().items()}
    out = eval_step(state, {k: torch.from_numpy(v).to(dt) for k, v in batch.items()})
    assert not state.model.training and set(out) == set(metrics)
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in before.items())
    return errs[worst]


def check_adam(kind):
    """The parameters after one fp64 Adam step, ``optax.adam`` against
    ``torch.optim.Adam``."""
    model, _, _, jstate, _, _, _ = run_steps(kind, 1, fp64=True, adam=True)
    got = _leaves(_flax(model)["params"])
    want = _leaves(jstate.params)
    errs = _per_tensor(got, want)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= PARAM_REL, (worst, errs[worst])


@pytest.mark.parametrize("fp64", [True, False], ids=["fp64", "fp32"])
def test_supervised_inpainting_step_matches_jax(fp64):
    check_step("supervised", fp64)


def test_supervised_inpainting_step_adam_matches_optax():
    check_adam("supervised")


def test_supervised_inpainting_step_on_the_ports_warp():
    """The port's step on its own warp in fp64 at the seeds where ROADMAP
    §C5 put the gradients 2.3e-2-6.1e-2 apart (seed 0 runs in
    ``test_supervised_inpainting_step_matches_jax``): the loss, the
    statistics within 1e-5, every gradient within ``GRAD_REL``."""
    for seed in (1, 2):
        check_step("supervised", True, seed)


def test_supervised_step_with_an_empty_hole_is_zero():
    """With no occluded pixel the masked L1 is 0 (the 1e-16 in its
    denominator keeps it finite)."""
    state = create_train_state(_seeded(5), LR, device="cpu")
    _, eval_step = make_supervised_inpainting_step()
    batch = {k: torch.from_numpy(v) for k, v in make_batch("supervised").items()}
    batch["occ"] = torch.zeros_like(batch["occ"])
    assert eval_step(state, batch)["loss"].item() == 0.0


def test_fma_warp_equals_the_jax_warp():
    """The port's warp with ``align_corners=False`` (its rescale rounded
    once, as a fused multiply-add rounds it) against the JAX package's
    jitted warp: fp64 images and flows, fp32 coordinates on both sides, to
    1e-12; also where a sample lies past the last column, where the warp
    that rounded twice read 6.9e-6 (ROADMAP §C5)."""
    from ocflow_tpu.ops.warp import warp as jwarp

    rng = np.random.default_rng(4)
    img = rng.uniform(-1, 1, (2, 64, 128, 3))
    flow = rng.normal(size=(2, 64, 128, 2)) * 3
    with jax.enable_x64(True):
        want = np.asarray(jwarp(jnp.asarray(img), jnp.asarray(flow), align_corners=False))
    got = warp(torch.from_numpy(img).permute(0, 3, 1, 2),
               torch.from_numpy(flow).permute(0, 3, 1, 2), align_corners=False)
    assert np.abs(got.permute(0, 2, 3, 1).numpy() - want).max() <= 1e-12
