"""The joint flow + occlusion + inpainting step over 2 gloo ranks
(``tests/torch_parallel_ranks.py:joint_case``): FlowOccNetCV and
InpaintingNet (train-mode BatchNorms, synced; under bf16 the synced
``_mixed``), two KITTI-like samples at 64x64, one a rank, the flow valid on
80% and 40% of them and the occlusion on 30% and 10%, so that the
valid-masked ratios' per-rank values are not the global ones.
FlowOccNetCV's last occlusion head is x100 in every case, as
``tests/test_torch_joint_step_bf16.py`` scales it: with the seeded head
~95% of the occlusion lies within 1e-2 of 0.5, and each rank's forward of
one sample (its convolutions summed in another order than over two) flips
pixels of the straight-through mask that the whole batch's does not; with
the seeded head the ranks' fp32 gradient read 1.1e-3 and 3.2e-3 of the
nets' max|grad| from the fp64 step, the single process's 4.8e-5 and
8.2e-5; with the head x100, 1.2e-4 and 3.8e-4 against 7.1e-5 and 2.4e-4.

- fp32, against the JAX package's fp32 step on the whole batch, at
  ``tests/test_torch_joint_step_fp32.py``'s bounds: every metric within
  1e-5 relative, the gradient (summed over the ranks) within 5e-2 relative
  L2 of the JAX package's, and each tensor within 1e-3 of its net's
  max|grad| of the port's single-process fp64 step on the whole batch;
- bf16 (``dtype: bfloat16``), against the port's single-process bf16
  step on the whole batch: every nonzero metric within 2e-2 relative.

Both ranks' metrics and states are equal bit for bit.
"""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import optax
import pytest

import torch_parallel_ranks as ranks
from ocflow_torch.tools.dryrun_multigpu import spawn
from ocflow_tpu.models import flow_occ_nets as jfon
from ocflow_tpu.models import inpainting_net as jinp
from ocflow_tpu.train import TrainState as JTrainState
from ocflow_tpu.train import steps_joint as jsteps
from test_torch_joint_step import _part, pair_flax
from test_torch_joint_step_bf16 import BF16_METRIC_REL
from test_torch_joint_step_fp32 import FP32_GRAD_L2, FP32_GRAD_REL, METRIC_REL, _per_tensor
from test_torch_ops import share_cores  # noqa: F401  (autouse)
from test_torch_two_stage_step import leaves, recording, whole_l2

WORLD = 2
KINDS = ("joint_fp32", "joint_bf16")


def _jax_fp32():
    variables = pair_flax(ranks.joint_pair(ranks.JOINT_OCC_SCALE))
    jstate = JTrainState.create(apply_fn=None, params=variables["params"],
                                tx=recording(optax.adam(1e-4)),
                                batch_stats=variables["batch_stats"])
    train, _ = jsteps.make_joint_step({"dtype": None}, jfon.FlowOccNetCV().apply,
                                      jinp.InpaintingNet().apply)
    jstate, jm = train(jstate, {k: jnp.asarray(v, jnp.float32)
                                for k, v in ranks.joint_batch().items()})
    return {k: float(v) for k, v in jm.items()}, leaves(jstate.opt_state[0])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' steps; here the JAX fp32 step and the port's
    single-process fp64 and bf16 steps."""
    tmp = tmp_path_factory.mktemp("joint")
    with ThreadPoolExecutor(1) as pool:
        done = pool.submit(spawn, ranks.sync_rank, WORLD, str(tmp), list(KINDS), timeout=300)
        want = {"jax_fp32": _jax_fp32(), "fp64": ranks.sync_single("joint_fp64"),
                "bf16": ranks.sync_single("joint_bf16")}
        done.result()
    per_rank = ranks.load_ranks(tmp, WORLD)
    return {k: [res[k] for res in per_rank] for k in KINDS}, want


def _grads(res):
    """A joint case's gradient in the flax tree's names."""
    return leaves(pair_flax(ranks.joint_pair(), res["grads"][0])["params"])


@pytest.mark.parametrize("kind", KINDS)
def test_joint_step_over_two_ranks(runs, kind):
    got, want = runs
    first = got[kind][0]
    for other in got[kind][1:]:
        assert other["metrics"] == first["metrics"]
    assert ranks.same_nets(got[kind])
    m = first["metrics"][0]
    if kind == "joint_bf16":
        ref = want["bf16"]["metrics"][0]
        rel = {k: abs(m[k] - v) / abs(v) for k, v in ref.items() if v}
        assert set(m) == set(ref) and max(rel.values()) <= BF16_METRIC_REL, rel
        return
    jm, jg = want["jax_fp32"]
    assert set(m) == set(jm)
    for k, v in jm.items():
        assert abs(m[k] - v) <= METRIC_REL * abs(v), (k, m[k], v)
    g, g64 = _grads(first), _grads(want["fp64"])
    assert whole_l2(g, jg) <= FP32_GRAD_L2
    per = {n: _per_tensor(_part(g, n), _part(g64, n)) for n in ("flow_occ", "inpaint")}
    assert all(p <= FP32_GRAD_REL for p in per.values()), per
