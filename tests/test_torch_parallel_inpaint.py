"""The supervised inpainting step and the stage step (InpaintingNet, its
twelve train-mode BatchNorms synced over the ranks) over 2 gloo ranks, fp64,
against the JAX package's steps on the whole batch under
``jax_enable_x64`` (``tests/torch_parallel_ranks.py:inpaint_case``): two
samples, one a rank, the hole over 60% of the first and 15% of the second,
so that the masked L1's per-rank ratio is not the global one. Held at
``tests/test_torch_inpaint_step_sup.py``'s fp64 bounds: the loss and every
metric within 1e-5 relative, each gradient (summed over the ranks) within
1e-4 of its max|grad|, the running statistics within 1e-5 of max|stat|;
both ranks' metrics and states equal bit for bit.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_ranks as ranks
from ocflow_torch.models import InpaintingNet
from ocflow_torch.tools.dryrun_multigpu import spawn
from ocflow_tpu.models import inpainting_net as jinp
from ocflow_tpu.train import TrainState as JTrainState
from ocflow_tpu.train import steps_inpainting as jsteps
from test_torch_inpaint_step_sup import (CAPTURE, GRAD_REL, METRIC_REL, STATS_REL, _flax,
                                         _leaves, _per_tensor)
from test_torch_ops import share_cores  # noqa: F401  (autouse)

WORLD = 2
KINDS = {"inpaint_sup": jsteps.make_supervised_inpainting_step,
         "inpaint_stage": jsteps.make_inpainting_stage_step}


def _jax_step(kind):
    variables = _flax(ranks.seeded_net(InpaintingNet, 0))
    with jax.enable_x64(True):
        cast = functools.partial(jax.tree_util.tree_map, lambda a: jnp.asarray(a, jnp.float64))
        jstate = JTrainState.create(apply_fn=jinp.InpaintingNet().apply,
                                    params=cast(variables["params"]), tx=CAPTURE,
                                    batch_stats=cast(variables["batch_stats"]))
        train, _ = KINDS[kind]({"loss_type": "pixel-wise"})
        batch = ranks.inpaint_batch(kind)
        jstate, jm = train(jstate, {k: jnp.asarray(v, jnp.float64) for k, v in batch.items()})
        return {k: float(v) for k, v in jm.items()}, jstate


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("inpaint")
    with ThreadPoolExecutor(1) as pool:
        done = pool.submit(spawn, ranks.sync_rank, WORLD, str(tmp), list(KINDS), timeout=300)
        want = {k: _jax_step(k) for k in KINDS}
        done.result()
    per_rank = ranks.load_ranks(tmp, WORLD)
    return {k: ([res[k] for res in per_rank], want[k]) for k in KINDS}


@pytest.mark.parametrize("kind", list(KINDS))
def test_inpainting_step_over_two_ranks_matches_jax(runs, kind):
    got, (jm, jstate) = runs[kind]
    first = got[0]
    assert all(r["metrics"] == first["metrics"] for r in got[1:])
    assert ranks.same_nets(got)
    metrics = first["metrics"][0]
    assert set(metrics) == set(jm)
    for k, v in jm.items():
        assert abs(metrics[k] - v) <= METRIC_REL * abs(v), (k, metrics[k], v)
    model = ranks.seeded_net(InpaintingNet, 0).double()
    for n, p in model.named_parameters():
        p.grad = first["grads"][0][n]
    errs = _per_tensor(_leaves(_flax(model, grads=True)["params"]), _leaves(jstate.opt_state))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_REL, (worst, errs[worst])
    model.load_state_dict(first["state"])
    have = _leaves(_flax(model)["batch_stats"])
    for k, w in _leaves(jstate.batch_stats).items():
        assert np.abs(have[k] - w).max() <= STATS_REL * np.abs(w).max(), k
