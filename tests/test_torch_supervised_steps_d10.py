"""One supervised train step of the FlowNetC family's flow+occlusion and
occlusion nets (FlowOccNetC under L1 + BCE, OcclusionNetC under the focal
BCE; the d=10 cost volume, BatchNorm in train mode) == the JAX package's
step, on the CPU at 2x64x128, with the bounds of
``tests/test_torch_supervised_steps.py`` (the summation-order bound,
1e-4 of each tensor's max|grad|)."""

import pytest

from test_torch_ops import share_cores  # noqa: F401  (autouse)
from test_torch_supervised_steps import D10_CASES, check_step


@pytest.mark.parametrize("key", D10_CASES)
def test_supervised_d10_step_matches_jax(key):
    check_step(key, D10_CASES[key])
