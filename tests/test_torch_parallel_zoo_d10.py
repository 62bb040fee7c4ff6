"""FlowOccNetC (d=10) over 2 gloo ranks, fp64: its supervised
flow+occlusion step, after its eval step, against the JAX package's steps
on the whole batch under ``jax_enable_x64``. Bounds and checks as
``tests/test_torch_parallel_zoo.py``'s; FlowNetC's unsupervised step:
``tests/test_torch_parallel_unsup_flownetc.py``.
"""

import pytest

from test_torch_ops import share_cores  # noqa: F401  (autouse)
from test_torch_parallel_c7 import check_zoo_case, run_cases

KEYS = ("flowoccnetc",)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("zoo_d10"), KEYS)


@pytest.mark.parametrize("key", KEYS)
def test_zoo_d10_step_over_two_ranks_matches_jax(runs, key):
    check_zoo_case(key, *runs[key])
