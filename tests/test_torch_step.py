"""One training step of the port == one step of ``ocflow_tpu``'s
``make_unsupervised_flow_step``, on the CPU, fp32 at 2x64x128 (FlowNetCV,
Adam 1e-4, occlusion-aware with range-map occlusion, photo 4.0, smooth1
0.5, smooth2 0.0), and its variants (``tests/test_torch_step_options.py``).

Off the TPU the JAX step falls back to flax autodiff of ``FlowNetCV.apply``:
an independent reference for the port's fused pair. Weights cross through
``convert_flownetcv``; the JAX gradients come out of optax's Adam state
(first step: mu = (1 - b1) g) and back through ``flownetcv_from_flax``.

Bounds: metrics rtol 1e-4, atol 1e-6; parameters after the step atol 5e-4,
rtol 2e-4, as tests/test_train_steps.py:271 (Adam's first step moves every
weight by about lr, so near-zero gradients of opposite sign differ by 2 lr);
gradients per parameter, max|port - jax| / max|jax|: the largest within
GRAD_REL, the median within GRAD_MEDIAN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ocflow_torch.bench import smooth_images
from ocflow_torch.models import FlowNetCV, flownetcv_from_flax
from ocflow_torch.train import create_train_state, make_unsupervised_flow_step
from ocflow_tpu.models import pwc_net as jpwc
from ocflow_tpu.models.torch_convert import convert_flownetcv
from ocflow_tpu.train import TrainState as JTrainState
from ocflow_tpu.train import steps as jsteps
from test_torch_ops import share_cores  # noqa: F401  (autouse)

HP = {"model": "pwc", "occ_aware": True, "occ_method": "range_map",
      "photo_weight": 4.0, "smooth1_weight": 0.5, "smooth2_weight": 0.0,
      "fast_forward": "both"}

# Per-parameter gradient bounds. The two sides sum the same terms in another
# order, and the photometric warp's gradient jumps where a flow crosses an
# integer pixel, so a 1e-5 flow difference moves a few pixels' terms; small
# bias gradients (sums of many cancelling terms) show it most. Measured on
# smooth_batch seeds 1 and 2 over the six cases: the largest per-parameter
# error 1.3e-3 (seed 1) and 4.2e-3 (seed 2, photo_half) with the charbonnier
# loss, 1.3e-2 with census (its soft transform steepens small grey
# differences); medians at most 1.9e-4 and 4.2e-3. The bounds are 2.4-5x
# those.
GRAD_REL = {"charbonnier": 1e-2, "census": 5e-2}
GRAD_MEDIAN = {"charbonnier": 1e-3, "census": 2e-2}

CASES = {
    "full": {},
    "occ_quarter": {"occ_resolution": "quarter"},
    "occ_half": {"occ_resolution": "half"},
    "photo_half": {"photo_resolution": "half"},
    "census": {"photo_loss": "census"},
    "with_occ": {"occ_aware": False, "with_occ": True},
}


def smooth_batch(seed=1, b=2, h=64, w=128):
    """Images: seeded uniform noise on an (h/8, w/8) grid, bicubic-upsampled
    8x (smooth like photographs; pixel noise has image gradients so large
    that the loss's gradient is dominated by the warp's jumps). Ground-truth
    flow and occlusion: noise."""
    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(rng.uniform(-1, 1, (b, 6, h // 8, w // 8)))
    return {"images": smooth_images(coarse).float().numpy(),
            "flow": rng.normal(size=(b, h, w, 2)).astype(np.float32),
            "occ": (rng.uniform(size=(b, h, w, 1)) > 0.8).astype(np.float32)}


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def check_step(case: str) -> None:
    hp = {**HP, **CASES[case]}
    batch = smooth_batch()
    model = FlowNetCV(generator=torch.Generator().manual_seed(0))
    variables = convert_flownetcv(model.state_dict())

    jstate = JTrainState.create(apply_fn=jpwc.FlowNetCV().apply,
                                params=variables["params"], tx=optax.adam(1e-4))
    jstep, _ = jsteps.make_unsupervised_flow_step(hp)
    jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    state = create_train_state(model, 1e-4, device="cpu")
    step, _ = make_unsupervised_flow_step(hp)
    state, metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert state.step == 1

    assert set(metrics) == set(jmetrics), (set(metrics), set(jmetrics))
    for k, v in metrics.items():
        np.testing.assert_allclose(float(v), float(jmetrics[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    jgrads = flownetcv_from_flax(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / 0.1, jstate.opt_state[0].mu))
    jparams = flownetcv_from_flax(jstate.params)
    loss = hp.get("photo_loss", "charbonnier")
    errs = {name: _rel(p.grad.numpy(), jgrads[name].numpy())
            for name, p in model.named_parameters()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_REL[loss], (worst, errs[worst])
    assert np.median(list(errs.values())) <= GRAD_MEDIAN[loss]
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jparams[name].numpy(),
                                   atol=5e-4, rtol=2e-4, err_msg=name)


@pytest.mark.parametrize("case", ["full", "occ_quarter", "occ_half"])
def test_step_matches_jax(case):
    check_step(case)
