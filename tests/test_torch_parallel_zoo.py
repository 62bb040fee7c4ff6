"""The supervised flow step of SimpleFlowNet and FlowNet (train-mode
BatchNorms, synced over the ranks) and its eval step over 2 gloo ranks,
fp64, against the JAX package's steps on the whole batch under
``jax_enable_x64``, at ``tests/test_torch_supervised_steps_fp64.py``'s
bounds: every metric within 1e-6 relative, each gradient within 1e-5 of its
max|grad| (a BatchNorm-fed bias against the net's), the running statistics
within 1e-9 of max|stat|. The case and the checks:
``tests/test_torch_parallel_c7.py``; the d=10 nets:
``tests/test_torch_parallel_zoo_d10.py``.
"""

import pytest

from test_torch_ops import share_cores  # noqa: F401  (autouse)
from test_torch_parallel_c7 import check_zoo_case, run_cases

KEYS = ("simple", "flownet")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("zoo"), KEYS)


@pytest.mark.parametrize("key", KEYS)
def test_supervised_zoo_step_over_two_ranks_matches_jax(runs, key):
    check_zoo_case(key, *runs[key])
