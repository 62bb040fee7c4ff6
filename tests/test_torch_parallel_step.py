"""The FlowNetCV training step over 2 gloo ranks
(``tests/torch_parallel_ranks.py:step_rank``: each rank its block of the
global batch, ``hparams['_fast_mesh']``) on the CPU:

- distinct examples, four pairs (two a rank): the occlusion-aware main path
  and a ground-truth occlusion mask that covers about 60% of the first
  rank's pairs and 10% of the second's (charbonnier and census), so that a
  per-rank ratio loss averaged over the ranks is not the global one. Each
  equals the single-process oracle (``hparams['_blocks'] = 2``: the forward
  per block, the losses on the whole batch): every metric within 1e-6
  relative (and 1e-12 absolute: ``smooth2``, weighted 0, is about 3e-10,
  an fp32 sum of terms across ten decades, and reads 1.5e-5 relative, 4e-15
  absolute), every gradient within 1e-5 of its max|grad|; the ranks'
  metrics and parameters equal bit for bit after two Adam steps;
- ``fast_apply`` and ``fast_apply_pair`` at 64x64 (a 1x1 map at level 6,
  the dry run's default size) hand the conv kernels channel-contiguous NCHW
  inputs (the kernels' own check, applied to every call's inputs here);
- the oracle's per-block forward (``fast_apply_pair`` on each half) ==
  the JAX flax ``FlowNetCV.apply`` on each half (and on its swapped
  frames for the backward flow) within 1e-4 of max|flow|.

The step on identical examples against the JAX step is
``tests/test_torch_parallel_step_jax.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from ocflow_torch import parallel
from ocflow_torch.models import FlowNetCV
from ocflow_torch.kernels.conv_chain import check_kernel_inputs
from ocflow_torch.models import pwc_fast
from ocflow_torch.models.pwc_fast import fast_apply_pair
from ocflow_torch.tools.dryrun_multigpu import spawn
from ocflow_tpu.models import pwc_net as jpwc
from ocflow_tpu.models.torch_convert import convert_flownetcv
from test_torch_ops import share_cores  # noqa: F401  (autouse)

WORLD = 2
METRIC_REL, METRIC_ABS, GRAD_REL = 1e-6, 1e-12, 1e-5
FORWARD_REL = 1e-4


@pytest.fixture(scope="module")
def per_rank(tmp_path_factory):
    out = tmp_path_factory.mktemp("step")
    spawn(ranks.step_rank, WORLD, str(out), False, timeout=300)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def oracle():
    """The single-process oracle of each case, on one thread as the ranks
    run (a CPU convolution sums in another order on more threads)."""
    batch = ranks.distinct_batch()
    hp = {**ranks.STEP_HP, "_blocks": WORLD, "_fast_mesh": parallel.Mesh(0, 1)}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {case: ranks.run_steps({**hp, **extra}, batch, 1)
                for case, extra in ranks.DISTINCT.items()}
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("case", list(ranks.DISTINCT))
def test_distinct_examples_match_the_oracle(per_rank, oracle, case):
    want = oracle[case]
    for res in per_rank:
        got = res[case]
        assert set(got["metrics"][0]) == set(want["metrics"][0])
        for k, v in want["metrics"][0].items():
            assert abs(got["metrics"][0][k] - v) <= METRIC_REL * abs(v) + METRIC_ABS, \
                (k, got["metrics"][0][k], v)
        for n, g in want["grads"].items():
            err = ((got["grads"][n] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item()
            assert err <= GRAD_REL, (n, err)


@pytest.mark.parametrize("case", list(ranks.DISTINCT))
def test_ranks_stay_equal_after_two_adam_steps(per_rank, case):
    first, *rest = (res[case] for res in per_rank)
    for other in rest:
        assert other["metrics"] == first["metrics"]
        assert all(torch.equal(other["params"][n], p) for n, p in first["params"].items())
    assert first["metrics"][1]["loss"] != first["metrics"][0]["loss"]


def test_the_masks_differ_between_the_ranks():
    occ = ranks.distinct_batch()["occ"]
    visible = [(1 - occ[:2]).mean().item(), (1 - occ[2:]).mean().item()]
    assert visible[1] - visible[0] > 0.4, visible


def test_oracle_blocks_match_flax_per_half():
    batch = ranks.distinct_batch()["images"]
    model = FlowNetCV(generator=torch.Generator().manual_seed(0))
    variables = convert_flownetcv({k: v.clone() for k, v in model.state_dict().items()})
    apply = jax.jit(jpwc.FlowNetCV().apply)
    with torch.no_grad():
        for half in batch.chunk(WORLD):
            fwd, bwd = fast_apply_pair(model, half, device="cpu")
            swapped = torch.cat([half[..., 3:], half[..., :3]], -1)
            for got, x in ((fwd, half), (bwd, swapped)):
                want = apply(variables, jnp.asarray(x.numpy()))
                for g, w in zip(got, want):
                    assert _rel(g.numpy(), np.asarray(w)) <= FORWARD_REL


def test_fast_apply_feeds_the_kernels_nchw_at_64x64(monkeypatch):
    model = FlowNetCV(generator=torch.Generator().manual_seed(0))
    x = ranks.smooth_batch(5, 2, 64, 64)["images"]
    seen = []
    group = pwc_fast.conv_group

    def checked(inputs, grp, *args, **kw):
        check_kernel_inputs(inputs, grp.packed[0], "conv_group")
        seen.append(len(inputs))
        return group(inputs, grp, *args, **kw)

    monkeypatch.setattr(pwc_fast, "conv_group", checked)
    with torch.no_grad():
        pwc_fast.fast_apply(model, x, device="cpu")
        fast_apply_pair(model, x, device="cpu")
    assert seen
