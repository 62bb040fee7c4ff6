"""One supervised train step of the port in fp64 == the JAX package's
under ``jax_enable_x64``, on the seeded init (biases zero, BatchNorm the
identity) of SimpleFlowNet, FlowNet and FlowOccNetCV ``pwoc``, at 2x64x128:
the fp64 half of ``tests/test_torch_supervised_steps.py``, whose docstring
states where the bounds come from (measured: loss 1.1e-7, gradients at most
8.4e-7 of max|grad|; the JAX package's warp keeps fp32 coordinates under
x64, ``ocflow_tpu/ops/warp.py``)."""

import pytest

from test_torch_ops import share_cores  # noqa: F401  (autouse)
from test_torch_supervised_steps import CASES, _grad_errors, _step

FP64_LOSS_REL = 1e-6   # relative
FP64_GRAD_REL = 1e-5   # per tensor, over max|grad| (a BatchNorm-fed bias over the net's)


@pytest.mark.parametrize("key", CASES)
def test_supervised_step_fp64_matches_jax(key):
    """The step of each net in fp64 on the seeded init, against the JAX step
    under ``jax_enable_x64``: loss within FP64_LOSS_REL, each gradient within
    FP64_GRAD_REL, as the module docstring states."""
    network_type, port_cls, jax_cls, convert = CASES[key]
    model, _, metrics, jstate, jmetrics, _, _ = _step(
        port_cls, jax_cls, convert, network_type, fp64=True)
    want = float(jmetrics["loss"])
    assert abs(metrics["loss"].item() - want) <= FP64_LOSS_REL * abs(want)
    errs = _grad_errors(key, convert, model, jstate)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= FP64_GRAD_REL, (worst, errs[worst])
