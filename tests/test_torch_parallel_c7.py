"""The supervised ``pwc`` step (the eager FlowNetCV, its features
normalized by the batch's moments before each correlation) and its eval
step over 2 gloo ranks, fp64, against the JAX package's steps on the whole
batch under ``jax_enable_x64`` (``tests/torch_parallel_ranks.py:
zoo_case``): ROADMAP §C7. Two distinct pairs of seeded frames, one a rank;
the eval step runs on the seeded weights, then one train step.

Held at ``tests/test_torch_supervised_steps_fp64.py``'s bounds: every
metric of either step within 1e-6 relative, each gradient (summed over the
ranks) within 1e-5 of its max|grad|. On the parent of this test's change
each rank normalized its features by its own block's moments, not the
batch's: this test failed there, the eval step's loss 4.4e-4 relative from
the JAX step's (49.6596 against 49.6816).

The helpers serve ``tests/test_torch_parallel_zoo*.py``: the ranks' step
runs while this process runs the JAX step.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np

import torch_parallel_ranks as ranks
from ocflow_torch.tools.dryrun_multigpu import spawn
from ocflow_tpu.models import flow_net as jfn
from ocflow_tpu.models import flow_net_s as jfns
from ocflow_tpu.models import flow_occ_nets as jfon
from ocflow_tpu.models import pwc_net as jpwc
from ocflow_tpu.models import simple_flow_net as jsfn
from ocflow_tpu.models import torch_convert as tc
from ocflow_tpu.train import TrainState as JTrainState
from ocflow_tpu.train import steps as jsteps
from test_torch_ops import share_cores  # noqa: F401  (autouse)
from test_torch_supervised_steps import CAPTURE, _grad_errors
from test_torch_zoo_nets import to_flax

WORLD = 2
LOSS_REL, GRAD_REL, STATS_REL = 1e-6, 1e-5, 1e-9
# the JAX net and converter of each case
JAX_NETS = {"pwc": (jpwc.FlowNetCV, tc.convert_flownetcv),
            "flownet": (jfn.FlowNet, tc.convert_flownet_fpn),
            "simple": (jsfn.SimpleFlowNet, tc.convert_simpleflownet),
            "flowoccnetc": (jfon.FlowOccNetC, tc.convert_flow_occ_net_c),
            "flownetc": (jfns.FlowNetC, tc.convert_flownetc)}
JAX_STEPS = {"flow": jsteps.make_supervised_flow_step,
             "flow-occ": jsteps.make_supervised_flow_occ_step}


def flax_of(key, model):
    """flax variables of ``model``'s tensors, copied (the converters return
    views), the gradients in the parameters' places where they are set."""
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    sd.update({k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None})
    return to_flax(type(model), JAX_NETS[key][1], sd)


def jax_zoo_step(key):
    """The JAX eval step on the seeded weights, then one train step, on the
    whole batch of the case ``key`` in fp64: ``(eval metrics, train
    metrics, state)``."""
    variables = flax_of(key, ranks.zoo_net(key))
    batch = ranks.zoo_batch(key)
    if key == "flownetc":
        train, evaluate = jsteps.make_unsupervised_flow_step(ranks.UNSUP_HP)
    else:
        train, evaluate = JAX_STEPS[ranks.ZOO[key][0]]({})
    with jax.enable_x64(True):
        cast = functools.partial(jax.tree_util.tree_map, lambda a: jnp.asarray(a, jnp.float64))
        stats = variables.get("batch_stats")
        jstate = JTrainState.create(apply_fn=JAX_NETS[key][0]().apply,
                                    params=cast(variables["params"]), tx=CAPTURE,
                                    batch_stats=cast(stats) if stats else {})
        jbatch = {k: jnp.asarray(v, jnp.float64) for k, v in batch.items()}
        jeval = {k: float(v) for k, v in evaluate(jstate, jbatch).items()}
        jstate, jm = train(jstate, jbatch)
        return jeval, {k: float(v) for k, v in jm.items()}, jstate


def run_cases(tmp, keys):
    """The cases ``keys`` over the ranks while this process runs their JAX
    steps: ``{key: (rank readings, JAX readings)}``."""
    with ThreadPoolExecutor(1) as pool:
        done = pool.submit(spawn, ranks.sync_rank, WORLD, str(tmp), list(keys), timeout=300)
        want = {k: jax_zoo_step(k) for k in keys}
        done.result()
    per_rank = ranks.load_ranks(tmp, WORLD)
    return {k: ([res[k] for res in per_rank], want[k]) for k in keys}


def check_zoo_case(key, got, want):
    """The case ``key``'s ranks against its JAX steps (the module docstring;
    the running statistics within ``STATS_REL`` of max|stat|); every rank
    returns the same metrics and the same state bit for bit."""
    jeval, jm, jstate = want
    first = got[0]
    for other in got[1:]:
        assert other["metrics"] == first["metrics"] and other["eval"] == first["eval"]
    assert ranks.same_nets(got)
    for metrics, ref in ((first["eval"], jeval), (first["metrics"][0], jm)):
        assert set(metrics) == set(ref)
        for k, v in ref.items():
            assert abs(metrics[k] - v) <= LOSS_REL * abs(v), (key, k, metrics[k], v)
    model = ranks.zoo_net(key).double()
    for n, p in model.named_parameters():
        p.grad = first["grads"][0][n]
    convert = functools.partial(to_flax, type(model), JAX_NETS[key][1])
    errs = _grad_errors(key, convert, model, jstate)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_REL, (key, worst, errs[worst])
    if jstate.batch_stats:
        model.load_state_dict(first["state"])
        have = jax.tree_util.tree_leaves_with_path(flax_of(key, model)["batch_stats"])
        have = {jax.tree_util.keystr(p): np.asarray(v) for p, v in have}
        for path, w in jax.tree_util.tree_leaves_with_path(jstate.batch_stats):
            w = np.asarray(w)
            assert np.abs(have[jax.tree_util.keystr(path)] - w).max() \
                <= STATS_REL * np.abs(w).max(), (key, path)


def test_pwc_steps_over_two_ranks_match_jax_on_the_whole_batch(tmp_path):
    got, want = run_cases(tmp_path, ["pwc"])["pwc"]
    check_zoo_case("pwc", got, want)
