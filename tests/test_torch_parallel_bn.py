"""Synced BatchNorm (``models.common.BatchNorm`` under
``parallel.synced_stats``) over 2 and 4 gloo ranks on the CPU
(``tests/torch_parallel_ranks.py:bn_case``): each rank normalizes its block
of one ``[8, 5, 6, 7]`` fp64 batch whose samples have offsets and scales of
their own, so that a block's statistics are not the batch's.

- Against one process on the whole batch (today's ``F.batch_norm`` path):
  the blocks' outputs and input gradients concatenated, the scale's and
  bias's gradients summed over the ranks, and every rank's running
  statistics, each within 1e-12 of its max; the same under
  ``frozen_stats``, whose running statistics stay as they were.
- Against flax's ``BatchNorm`` (``momentum=0.9``, ``epsilon=1e-5``) on the
  whole batch under ``jax_enable_x64``: the same readings within 1e-10.
- ``_mixed`` (``apply_mixed`` under the bf16 policy) over the ranks against
  jitted flax under the JAX package's bf16 policy on the whole batch: the
  running statistics within 1e-6 of max, the output within 2^-7 of max
  (``tests/test_torch_precision.py``'s bounds), and against the port's
  single-process ``_mixed`` within 1e-6 and 2^-7 as well.
- A mesh of one is the single-process path bit for bit: the case itself,
  and a stage inpainting step built with ``_fast_mesh: Mesh(0, 1)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from ocflow_torch import parallel
from ocflow_torch.tools.dryrun_multigpu import spawn
from ocflow_tpu.models.precision import apply_mixed as japply_mixed
from test_torch_ops import share_cores  # noqa: F401  (autouse)
from test_torch_precision import _FlaxBN

SINGLE_REL, FLAX_REL = 1e-12, 1e-10
MIXED_STATS_REL, MIXED_OUT_REL = 1e-6, 2.0 ** -7


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def per_rank(request, tmp_path_factory):
    out = tmp_path_factory.mktemp(f"bn{request.param}")
    spawn(ranks.sync_rank, request.param, str(out), ["bn"], timeout=240)
    return [res["bn"] for res in ranks.load_ranks(out, request.param)]


@pytest.fixture(scope="module")
def single():
    return ranks.bn_case(None)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _gathered(per_rank, part):
    """The ranks' readings of ``part`` as the whole batch's: outputs and
    input gradients concatenated, parameter gradients summed, rank 0's
    running statistics (every rank's are held equal)."""
    first = per_rank[0][part]
    for res in per_rank[1:]:
        for k in ("mean", "var"):
            assert torch.equal(res[part][k], first[k]), (part, k)
    out = {k: torch.cat([r[part][k] for r in per_rank]) for k in ("y", "dx") if k in first}
    out.update({k: sum(r[part][k] for r in per_rank) for k in ("dweight", "dbias")
                if k in first})
    return {**out, "mean": first["mean"], "var": first["var"]}


@pytest.mark.parametrize("part", ["train", "frozen"])
def test_synced_batchnorm_equals_one_process(per_rank, single, part):
    got = _gathered(per_rank, part)
    for k, v in got.items():
        assert _rel(v, single[part][k]) <= SINGLE_REL, (part, k, _rel(v, single[part][k]))
    assert all(r[part]["count"] == single[part]["count"] for r in per_rank)
    if part == "frozen":
        inp = ranks.bn_inputs()
        assert np.array_equal(got["mean"].numpy(), inp["mean"])
        assert np.array_equal(got["var"].numpy(), inp["var"])
        assert single["frozen"]["count"] == 0


def _flax_fp64():
    """flax's train-mode BatchNorm on the whole batch in fp64: the output,
    the input's and the parameters' gradients for the cotangent, the
    updated statistics; NCHW."""
    inp = ranks.bn_inputs()
    nhwc = lambda a: jnp.asarray(np.transpose(a, (0, 2, 3, 1)))  # noqa: E731
    with jax.enable_x64(True):
        params = {"BatchNorm_0": {"scale": jnp.asarray(inp["weight"]),
                                  "bias": jnp.asarray(inp["bias"])}}
        stats = {"BatchNorm_0": {"mean": jnp.asarray(inp["mean"]),
                                 "var": jnp.asarray(inp["var"])}}

        def apply(p, x):
            return _FlaxBN().apply({"params": p, "batch_stats": stats}, x, train=True,
                                   mutable=["batch_stats"])

        y, upd = apply(params, nhwc(inp["x"]))
        _, vjp = jax.vjp(lambda p, x: apply(p, x)[0], params, nhwc(inp["x"]))
        dparams, dx = vjp(nhwc(inp["g"]))
        nchw = lambda a: np.transpose(np.asarray(a), (0, 3, 1, 2))  # noqa: E731
        return {"y": nchw(y), "dx": nchw(dx),
                "dweight": np.asarray(dparams["BatchNorm_0"]["scale"]),
                "dbias": np.asarray(dparams["BatchNorm_0"]["bias"]),
                "mean": np.asarray(upd["batch_stats"]["BatchNorm_0"]["mean"]),
                "var": np.asarray(upd["batch_stats"]["BatchNorm_0"]["var"])}


def test_synced_batchnorm_matches_flax_fp64(per_rank):
    want = _flax_fp64()
    got = _gathered(per_rank, "train")
    for k, w in want.items():
        assert _rel(got[k], w) <= FLAX_REL, (k, _rel(got[k], w))


def test_synced_mixed_batchnorm_matches_flax_bf16(per_rank, single):
    inp = ranks.bn_inputs()
    x16 = torch.from_numpy(inp["x"]).float().bfloat16().float().numpy()
    variables = {"params": {"BatchNorm_0": {"scale": inp["weight"].astype(np.float32),
                                            "bias": inp["bias"].astype(np.float32)}},
                 "batch_stats": {"BatchNorm_0": {"mean": inp["mean"].astype(np.float32),
                                                 "var": inp["var"].astype(np.float32)}}}
    out, upd = jax.jit(lambda v, a: japply_mixed(_FlaxBN().apply, v, a, dtype=jnp.bfloat16,
                                                 mutable=["batch_stats"], train=True))(
        variables, jnp.asarray(np.transpose(x16, (0, 2, 3, 1))))
    got = _gathered(per_rank, "mixed")
    for k in ("mean", "var"):
        want = np.asarray(upd["batch_stats"]["BatchNorm_0"][k])
        assert _rel(got[k], want) <= MIXED_STATS_REL, k
        assert _rel(got[k], single["mixed"][k]) <= MIXED_STATS_REL, k
    want = np.transpose(np.asarray(out), (0, 3, 1, 2))
    assert _rel(got["y"], want) <= MIXED_OUT_REL
    assert _rel(got["y"], single["mixed"]["y"]) <= MIXED_OUT_REL


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def test_a_mesh_of_one_is_the_single_process_path(single):
    assert _equal(ranks.bn_case(parallel.Mesh(0, 1)), single)
    one = ranks.inpaint_case("inpaint_stage", parallel.Mesh(0, 1))
    assert _equal(one, ranks.inpaint_case("inpaint_stage", None))
