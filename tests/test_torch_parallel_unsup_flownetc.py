"""FlowNetC (d=10) over 2 gloo ranks, fp64: its occlusion-aware
unsupervised step (``configs/longrun_synthetic.yaml``'s hparams; both
passes in train mode, so each takes the global batch's statistics), after
its eval step, against the JAX package's steps on the whole batch under
``jax_enable_x64``. Bounds and checks as
``tests/test_torch_parallel_zoo.py``'s.
"""

import pytest

from test_torch_ops import share_cores  # noqa: F401  (autouse)
from test_torch_parallel_c7 import check_zoo_case, run_cases

KEYS = ("flownetc",)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("unsup_flownetc"), KEYS)


@pytest.mark.parametrize("key", KEYS)
def test_unsupervised_flownetc_step_over_two_ranks_matches_jax(runs, key):
    check_zoo_case(key, *runs[key])
