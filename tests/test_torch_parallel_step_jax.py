"""The FlowNetCV training step over 2 gloo ranks on identical examples
(``tests/torch_parallel_ranks.py:step_rank``; one pair twice, so each
rank's feature normalization equals the whole batch's) == the JAX package's
single-device step on the whole batch, on the CPU, at
``tests/test_torch_step.py``'s bounds: metrics rtol 1e-4 atol 1e-6; each
gradient's max-abs over its max|grad| within 1e-2, the median within 1e-3;
the parameters after Adam atol 5e-4, rtol 2e-4. Distinct examples against
the single-process oracle: ``tests/test_torch_parallel_step.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_ranks as ranks
from ocflow_torch.models import FlowNetCV, flownetcv_from_flax
from ocflow_torch.tools.dryrun_multigpu import spawn
from ocflow_tpu.models import pwc_net as jpwc
from ocflow_tpu.models.torch_convert import convert_flownetcv
from ocflow_tpu.train import TrainState as JTrainState
from ocflow_tpu.train import steps as jsteps
from test_torch_ops import share_cores  # noqa: F401  (autouse)

WORLD = 2


@pytest.fixture(scope="module")
def per_rank(tmp_path_factory):
    out = tmp_path_factory.mktemp("step_jax")
    spawn(ranks.step_rank, WORLD, str(out), True, timeout=300)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def jax_step():
    """The JAX step on the whole batch: metrics, gradients, parameters."""
    batch = {k: v.numpy() for k, v in ranks.identical_batch().items()}
    model = FlowNetCV(generator=torch.Generator().manual_seed(0))
    variables = convert_flownetcv(model.state_dict())
    jstate = JTrainState.create(apply_fn=jpwc.FlowNetCV().apply,
                                params=variables["params"], tx=optax.adam(ranks.LR))
    jstep, _ = jsteps.make_unsupervised_flow_step(ranks.STEP_HP)
    jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    jgrads = flownetcv_from_flax(jax.tree_util.tree_map(
        lambda m: np.asarray(m) / 0.1, jstate.opt_state[0].mu))
    return jmetrics, jgrads, flownetcv_from_flax(jstate.params)


@pytest.mark.parametrize("rank", range(WORLD))
def test_identical_examples_match_the_jax_step(per_rank, jax_step, rank):
    jmetrics, jgrads, jparams = jax_step
    got = per_rank[rank]["identical"]
    assert set(got["metrics"][0]) == set(jmetrics)
    for k, v in got["metrics"][0].items():
        np.testing.assert_allclose(v, float(jmetrics[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    errs = {n: _rel(g.numpy(), jgrads[n].numpy()) for n, g in got["grads"].items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-2, (worst, errs[worst])
    assert np.median(list(errs.values())) <= 1e-3
    for n, p in got["params"].items():
        np.testing.assert_allclose(p.numpy(), jparams[n].numpy(), atol=5e-4, rtol=2e-4,
                                   err_msg=n)
