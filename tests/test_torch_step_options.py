"""The port's training step == the JAX package's under the loss options:
the photometric term at half resolution, the census loss, and ground-truth
occlusion masking without ``occ_aware`` (cases and bounds:
``tests/test_torch_step.py``, whose helper this file shares; two files keep
each under a minute)."""

import pytest

from test_torch_ops import share_cores  # noqa: F401  (autouse)
from test_torch_step import check_step


@pytest.mark.parametrize("case", ["photo_half", "census", "with_occ"])
def test_step_option_matches_jax(case):
    check_step(case)
