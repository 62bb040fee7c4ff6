"""The two-stage pipelines over 2 gloo ranks, fp64, against the JAX
package's steps on the whole batch under ``jax_enable_x64``
(``tests/torch_parallel_ranks.py:two_stage_case``), two samples at 64x64,
one a rank, the occlusion over 50% and 10%:

- TwoStageModel: the trainable SimpleOcclusionNet (train-mode BatchNorms,
  synced) behind the frozen SimpleFlowNet (eval mode), two Adam steps;
- TwoStageModelGC: SimpleOcclusionNet and InpaintingNet under the gated
  Adam, the inpainter gated for one update: one step in each phase.

Held at ``tests/test_torch_two_stage_step.py``'s and
``tests/test_torch_two_stage_gc.py``'s fp64 bounds at both steps: every
metric within 1e-5 relative, each gradient (summed over the ranks) within
1e-4 of its max|grad| (a gradient zero but for rounding within 1e-12 of its
net's max), the running statistics within 1e-5 of max|stat|; the frozen
flow net unchanged; the GC inpainter's parameters equal to the seeded ones
bit for bit after the gated step and moved after the unfrozen one, in both
packages; both ranks' metrics and states equal bit for bit.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_parallel_ranks as ranks
from ocflow_torch.tools.dryrun_multigpu import spawn
from ocflow_tpu.models import inpainting_net as jinp
from ocflow_tpu.models import occlusion_nets as jocc
from ocflow_tpu.models import simple_flow_net as jsfn
from ocflow_tpu.models import torch_convert as tc
from ocflow_tpu.train import TrainState as JTrainState
from ocflow_tpu.train import steps_two_stage as jsteps
from test_torch_gan_step import hold_tensors
from test_torch_ops import share_cores  # noqa: F401  (autouse)
from test_torch_two_stage_gc import _part, pair_flax
from test_torch_two_stage_step import (GRAD_REL, METRIC_REL, STATS_REL, flax_of, leaves,
                                       per_tensor, recording)

WORLD = 2
KINDS = ("two_stage", "gc")


def _jax_steps(kind):
    """Two steps of the JAX pipeline ``kind`` from the ranks' weights: each
    step's metrics, raw gradients, parameters and statistics."""
    batch = ranks.two_stage_batch(kind == "gc")
    with jax.enable_x64(True):
        cast = functools.partial(jax.tree_util.tree_map, lambda a: jnp.asarray(a, jnp.float64))
        jbatch = {k: jnp.asarray(v, jnp.float64) for k, v in batch.items()}
        if kind == "gc":
            v = pair_flax(ranks.gc_pair(), "simple")
            tx = recording(jsteps.make_two_stage_gc_optimizer(
                ranks.GC_LR, ranks.GC_INPAINT_LR, ranks.GC_UNFREEZE))
            train, _ = jsteps.make_two_stage_gc_step(
                ranks.GC_HP, jocc.SimpleOcclusionNet().apply, jinp.InpaintingNet().apply)
            args, apply = (), None
        else:
            occ, flow, inp = ranks.two_stage_nets()
            v = flax_of(tc.convert_simple_occlusion_net, occ)
            tx = recording(optax.adam(1e-3))
            train, _ = jsteps.make_two_stage_step(ranks.TWO_STAGE_HP, jsfn.SimpleFlowNet().apply,
                                                  jinp.InpaintingNet().apply)
            args = (cast({"flow": flax_of(tc.convert_simpleflownet, flow),
                          "inpaint": flax_of(tc.convert_inpainting_net, inp)}),)
            apply = jocc.SimpleOcclusionNet().apply
        jstate = JTrainState.create(apply_fn=apply, params=cast(v["params"]), tx=tx,
                                    batch_stats=cast(v["batch_stats"]))
        steps = [(None, None, leaves(jstate.params), None)]
        for _ in range(2):
            jstate, m = train(jstate, *args, jbatch)
            steps.append(({k: float(x) for k, x in m.items()}, leaves(jstate.opt_state[0]),
                          leaves(jstate.params), leaves(jstate.batch_stats)))
        return steps


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("two_stage")
    with ThreadPoolExecutor(1) as pool:
        done = pool.submit(spawn, ranks.sync_rank, WORLD, str(tmp), list(KINDS), timeout=300)
        want = {k: _jax_steps(k) for k in KINDS}
        done.result()
    per_rank = ranks.load_ranks(tmp, WORLD)
    return {k: ([res[k] for res in per_rank], want[k]) for k in KINDS}


def _port_steps(kind, res):
    """The ranks' steps as the JAX readings: ``(metrics, gradients,
    parameters, statistics)`` per step, flax names."""
    if kind == "gc":
        model = ranks.gc_pair().double()
        flat = lambda grads=None: pair_flax(model, "simple", grads)  # noqa: E731
    else:
        model = ranks.two_stage_nets()[0].double()
        flat = functools.partial(flax_of, tc.convert_simple_occlusion_net, model)
    out = [(None, None, leaves(flat()["params"]), None)]
    for i in range(2):
        model.load_state_dict(res["states"][i])
        now = flat()
        out.append((res["metrics"][i], leaves(flat(res["grads"][i])["params"]),
                    leaves(now["params"]), leaves(now["batch_stats"])))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_two_stage_steps_over_two_ranks_match_jax(runs, kind):
    got, jax_steps = runs[kind]
    first = got[0]
    for other in got[1:]:
        assert other["metrics"] == first["metrics"]
    assert ranks.same_nets(got)
    if kind == "two_stage":
        assert all(r["frozen_unchanged"] for r in got)
    port_steps = _port_steps(kind, first)
    for i in (1, 2):
        (m, g, p, st), (jm, jg, jp, jst) = port_steps[i], jax_steps[i]
        assert set(m) == set(jm)
        for k, v in jm.items():
            assert abs(m[k] - v) <= METRIC_REL * abs(v), (i, k, m[k], v)
        nets = ("occ", "inpaint") if kind == "gc" else (None,)
        for name in nets:
            part = (lambda t: t) if name is None else functools.partial(_part, name=name)
            if kind == "gc":
                hold_tensors(f"step {i - 1} {name}", part(g), part(jg), GRAD_REL)
            else:
                errs = per_tensor(g, jg)
                worst = max(errs, key=errs.get)
                assert errs[worst] <= GRAD_REL, (i, worst, errs[worst])
        for k, w in jst.items():
            assert np.abs(st[k] - w).max() <= STATS_REL * np.abs(w).max(), (i, k)
        if kind == "gc":
            gated = i <= ranks.GC_UNFREEZE
            seeded = _part(port_steps[0][2], "inpaint")
            for k, v in seeded.items():
                assert np.array_equal(p[k], v) == gated, (i, k)
                assert np.array_equal(jp[k], v) == gated, (i, k)
