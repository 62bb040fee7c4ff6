"""The port's H-sharded cost volume and warp (``ocflow_torch.parallel.spatial``)
on 2 and 4 gloo ranks (``tests/torch_parallel_ranks.py:spatial_rank``) ==
the JAX package's ``spatial_cost_volume`` / ``spatial_warp`` over the 8
virtual CPU devices, at its test's shapes (``tests/test_spatial_parallel.py``:
features 2x32x16x8 at d = 2 and 4, an image 1x32x16x3 warped by flows in
[-2, 2] with ``max_flow`` 2, both ``align_corners``), within 1e-5 (atol and
rtol, the JAX test's bounds). The ranks' rows put together, in rank order,
are the whole output. Each cost volume's gradient (the backward kernel's
plain version on the CPU, the slice, the pad and the halo's adjoint)
equals the single-process gradient's rows within 1e-6 of max|grad| (the
halo rows sum their two contributions in another order: readings 2e-7 to
5e-7). ``halo_exchange`` puts the neighbours' rows around a block and zeros
past the ends.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from ocflow_torch.tools.dryrun_multigpu import spawn
from ocflow_tpu.parallel.mesh import make_mesh as j_make_mesh
from ocflow_tpu.parallel.spatial import spatial_cost_volume, spatial_warp
from test_torch_ops import share_cores  # noqa: F401  (autouse)

TOL = 1e-5
GRAD_TOL = 1e-6


def _inputs():
    """The JAX test's arrays (NHWC, seed 42)."""
    rng = np.random.default_rng(42)
    f1 = rng.standard_normal((2, 32, 16, 8)).astype(np.float32)
    f2 = rng.standard_normal((2, 32, 16, 8)).astype(np.float32)
    img = rng.standard_normal((1, 32, 16, 3)).astype(np.float32)
    flow = rng.uniform(-2, 2, (1, 32, 16, 2)).astype(np.float32)
    return {"f1": f1, "f2": f2, "img": img, "flow": flow}


@pytest.fixture(scope="module")
def jax_out():
    mesh = j_make_mesh()
    a = {k: jnp.asarray(v) for k, v in _inputs().items()}
    out = {}
    for d in (2, 4):
        fn = jax.jit(lambda x, y, d=d: spatial_cost_volume(x, y, d, mesh))
        out[f"cv{d}"] = np.asarray(fn(a["f1"], a["f2"]))
    for ac in (True, False):
        fn = jax.jit(lambda x, y, ac=ac: spatial_warp(x, y, 2, mesh, align_corners=ac))
        out[f"warp_{ac}"] = np.asarray(fn(a["img"], a["flow"]))
    return out


@pytest.fixture(scope="module", params=[2, 4])
def ranks_out(request, tmp_path_factory):
    world = request.param
    out = tmp_path_factory.mktemp(f"spatial{world}")
    nchw = {k: torch.from_numpy(np.ascontiguousarray(v.transpose(0, 3, 1, 2)))
            for k, v in _inputs().items()}
    spawn(ranks.spatial_rank, world, str(out), nchw, timeout=240)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _whole(per_rank, key):
    """The ranks' rows put together, NHWC."""
    return torch.cat([r[key] for r in per_rank], 2).permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("d", [2, 4])
def test_spatial_cost_volume_matches_jax(ranks_out, jax_out, d):
    np.testing.assert_allclose(_whole(ranks_out, f"cv{d}"), jax_out[f"cv{d}"],
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("align_corners", [True, False])
def test_spatial_warp_matches_jax(ranks_out, jax_out, align_corners):
    np.testing.assert_allclose(_whole(ranks_out, f"warp_{align_corners}"),
                               jax_out[f"warp_{align_corners}"], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("d", [2, 4])
def test_spatial_cost_volume_gradient_matches_one_process(ranks_out, d):
    errs = [r[f"cv{d}_grad_err"] for r in ranks_out]
    assert max(errs) <= GRAD_TOL, errs


def test_halo_exchange_rows(ranks_out):
    world = len(ranks_out)
    for r, res in enumerate(ranks_out):
        start, stop = res["rows"]
        got = res["halo"].flatten().tolist()
        above = [0.0, 0.0] if r == 0 else [start - 2.0, start - 1.0]
        below = [0.0, 0.0] if r == world - 1 else [stop + 0.0, stop + 1.0]
        assert got == above + list(map(float, range(start, stop))) + below
