"""The port's multi-process layer (``ocflow_torch.parallel``) on the CPU:

- the batch blocks of ``shard_batch``, of ``device_iterator(loader, device,
  mesh)`` and of a loader built with ``block=(rank, world)``, for a world of
  8, equal bit for bit each device's shard of the JAX package's
  ``device_iterator(loader, make_mesh())`` over the 8 virtual CPU devices,
  the ragged 5-item eval batch (padded by its last sample) included;
- ``DataLoader(shard_index, num_shards)`` gives the JAX loader's indices;
- ``initialize`` raises on a bad explicit configuration and returns False
  with no cluster; one process is a mesh of one;
- on two gloo ranks joined through a ``file://`` store
  (``tests/torch_parallel_ranks.py``): the collectives,
  ``global_mean_metrics`` (the mean of the ranks' means), the replicas'
  broadcast and check, the meshes that raise, SimpleFlowNet's unsupervised
  and supervised steps (train-mode BatchNorms, synced over the ranks, fp64)
  equal to the single-process steps on the whole batch (metrics 1e-6
  relative, gradients 1e-5 of max|grad|), ``fit`` refusing a step not
  built for the mesh, and
  ``fast_apply_sharded`` / ``fast_apply_pair_sharded`` (each rank's block
  and the gathered batch) equal to the single-process forwards of the
  blocks bit for bit; the supervised flow step (PWCNet, MSE) over the ranks
  equal to the single-process step on the whole batch (loss 1e-6 relative,
  gradients 1e-5 of max|grad|);
- ``python -m ocflow_torch.tools.dryrun_multigpu --nproc 2 --device cpu``
  exits 0 (its step equals the single-process oracle, the replicas equal).
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from ocflow_torch import data as tdata
from ocflow_torch import parallel
from ocflow_torch.tools.dryrun_multigpu import spawn
from ocflow_tpu import data as jdata
from ocflow_tpu.parallel.mesh import make_mesh as j_make_mesh
from test_torch_ops import share_cores  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
WORLD = 2


class Numbered:
    """Sample ``i``: its index and a small map of it, numpy (both loaders)."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.int64(i), "x": np.full((2, 3), i, np.float32) + np.arange(3)}


def _jax_blocks(loader, mesh):
    """Each device's shard of each JAX batch, in the mesh's device order."""
    order = list(mesh.devices.flat)
    out = []
    for batch in jdata.device_iterator(loader, mesh):
        per = [{} for _ in order]
        for k, arr in batch.items():
            for s in arr.addressable_shards:
                per[order.index(s.device)][k] = np.asarray(s.data)
        out.append(per)
    return out


@pytest.mark.parametrize("n,batch_size", [(16, 8), (5, 5), (21, 8)])
def test_blocks_match_jax_device_shards(n, batch_size):
    mesh = j_make_mesh()
    assert mesh.devices.size == 8
    ds = Numbered(n)
    want = _jax_blocks(jdata.DataLoader(ds, batch_size, drop_last=False, num_workers=0), mesh)
    whole = list(tdata.DataLoader(ds, batch_size, drop_last=False, num_workers=0))
    for r in range(8):
        m = parallel.Mesh(r, 8)
        iterated = list(tdata.device_iterator(
            tdata.DataLoader(ds, batch_size, drop_last=False, num_workers=0), "cpu", m))
        blocked = list(tdata.device_iterator(
            tdata.DataLoader(ds, batch_size, drop_last=False, num_workers=0, block=(r, 8)),
            "cpu", m))
        assert len(iterated) == len(blocked) == len(want)
        for b, (it, bl) in enumerate(zip(iterated, blocked)):
            for k in ("i", "x"):
                assert np.array_equal(it[k].numpy(), want[b][r][k]), (r, b, k)
                assert np.array_equal(bl[k].numpy(), want[b][r][k]), (r, b, k)
                if whole[b][k].shape[0] % 8 == 0:
                    assert np.array_equal(parallel.shard_batch(whole[b], m)[k].numpy(),
                                          want[b][r][k])


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, True), (True, False)])
@pytest.mark.parametrize("num_shards", [1, 2, 3])
def test_dataloader_shards_match_jax(shuffle, drop_last, num_shards):
    ds = Numbered(23)
    for idx in range(num_shards):
        kw = dict(batch_size=4, shuffle=shuffle, seed=7, drop_last=drop_last, num_workers=0,
                  shard_index=idx, num_shards=num_shards)
        jl, tl = jdata.DataLoader(ds, **kw), tdata.DataLoader(ds, **kw)
        for epoch in (0, 1):
            jl.set_epoch(epoch)
            tl.set_epoch(epoch)
            assert len(jl) == len(tl)
            assert [list(b["i"]) for b in jl] == [b["i"].tolist() for b in tl]


def test_block_loader_needs_a_divisible_train_batch():
    with pytest.raises(ValueError, match="does not split"):
        tdata.DataLoader(Numbered(8), 3, drop_last=True, block=(0, 2))


@pytest.mark.parametrize("kwargs,exc", [
    ({"coordinator_address": "localhost:1234", "num_processes": 2}, ValueError),
    ({"coordinator_address": "localhost:1234", "num_processes": 2, "process_id": 2},
     ValueError),
    ({"coordinator_address": "localhost", "num_processes": 2, "process_id": 0}, ValueError),
    ({"coordinator_address": "localhost:1234", "num_processes": 2, "process_id": 0,
      "backend": "mpi"}, ValueError),
    ({"coordinator_address": "localhost:1234", "num_processes": 2, "process_id": 0,
      "backend": "nccl"}, RuntimeError),
])
def test_initialize_raises_on_a_bad_explicit_config(kwargs, exc):
    with pytest.raises(exc) as info:
        parallel.initialize(**kwargs)
    if kwargs.get("backend") == "nccl":
        assert 'backend="gloo"' in str(info.value)
    assert not torch.distributed.is_initialized()


def test_one_process_is_a_mesh_of_one(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert parallel.initialize() is False
    assert not torch.distributed.is_initialized()
    mesh = parallel.make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.shape) == (0, 1, (1,))
    assert parallel.default_mesh((1,), "cpu") is None
    with pytest.raises(ValueError):
        parallel.make_mesh((2,))
    assert parallel.is_main_process() and parallel.local_shard_info() == (0, 1)
    assert parallel.global_mean_metrics({"loss": 0.5}) == {"loss": 0.5}
    x = torch.arange(6.0)
    assert torch.equal(mesh.all_gather(x), x) and torch.equal(parallel.shard_batch(x, mesh), x)


@pytest.fixture(scope="module")
def dist(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist")
    spawn(ranks.dist_rank, WORLD, str(out), timeout=240)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def test_ranks_see_the_group(dist):
    for r, res in enumerate(dist):
        assert res["again"] is True and res["world"] == WORLD
        assert res["main"] == (r == 0) and res["shard_info"] == (r, WORLD)


def test_global_mean_metrics_is_the_mean_of_means(dist):
    for res in dist:
        assert res["means"] == {"b": 1.0, "a": 1.5}
        assert list(res["means"]) == ["b", "a"]


def test_collectives(dist):
    for r, res in enumerate(dist):
        assert res["gathered"].tolist() == [[0, 0], [1, 10]]
        assert res["summed"].tolist() == [3.0] and res["broadcast"].tolist() == [5.0]
        from_prev, from_next = res["exchange"]
        # rank - 1's to_next (200 + r - 1), rank + 1's to_prev (100 + r + 1)
        assert from_prev.tolist() == ([0.0] if r == 0 else [199.0 + r])
        assert from_next.tolist() == ([0.0] if r == WORLD - 1 else [101.0 + r])


def test_replicas_are_broadcast_and_checked(dist):
    for res in dist:
        assert torch.equal(res["replicated"], torch.zeros(2, 3))
        assert "diverged" in res["diverged"]


def test_meshes_and_batches_that_do_not_fit_raise(dist):
    for res in dist:
        assert "over a world of 2" in res["bad_shape"]
        assert "one data axis" in res["two_axes"]
        assert "does not split" in res["ragged"]


def _one_process(fn, *args):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks run: a CPU conv sums in another order on more
    try:
        return fn(*args)
    finally:
        torch.set_num_threads(threads)


def _hold_step(got, want):
    """Every metric within 1e-6 relative, every gradient within 1e-5 of its
    max|grad|; a gradient zero but for rounding (within 1e-12 of the net's
    largest: a bias that reaches the loss only through a train-mode
    BatchNorm) against the net's largest."""
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        assert abs(got["metrics"][k] - v) <= 1e-6 * abs(v), (k, got["metrics"][k], v)
    top = max(g.abs().max().item() for g in want["grads"].values())
    for n, g in want["grads"].items():
        scale = g.abs().max().item()
        scale = top if scale <= 1e-12 * top else scale
        err = (got["grads"][n] - g).abs().max().item() / scale
        assert err <= 1e-5, (n, err)


@pytest.mark.parametrize("step", ["unsupervised", "supervised"])
def test_batchnorm_nets_over_two_ranks_equal_one_process(dist, step):
    want = _one_process(ranks.simple_step, step, {"_fast_mesh": parallel.Mesh(0, 1)},
                        ranks.smooth_batch(8, 2))
    for res in dist:
        _hold_step(res[f"bn_{step}"], want)


def test_fit_refuses_a_step_built_without_the_mesh(dist):
    for res in dist:
        assert "was not built for 2 ranks" in res["fit_unsharded_step"]


@pytest.mark.parametrize("which", ["sharded_serving", "sharded_pair"])
def test_sharded_forwards_equal_the_blocks_forwards(dist, which):
    for res in dist:
        assert res[which] == (0.0, 0.0)
        assert "gather is for serving" in res["diff_gather"]


def test_supervised_step_over_two_ranks_equals_one_process(dist):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks run: a CPU conv sums in another order on more
    try:
        want = ranks.supervised_step({"_fast_mesh": parallel.Mesh(0, 1)},
                                     ranks.smooth_batch(7, 4))
    finally:
        torch.set_num_threads(threads)
    for res in dist:
        got = res["supervised"]
        assert abs(got["metrics"]["loss"] - want["metrics"]["loss"]) \
            <= 1e-6 * abs(want["metrics"]["loss"])
        for n, g in want["grads"].items():
            err = ((got["grads"][n] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item()
            assert err <= 1e-5, (n, err)


def test_dryrun_multigpu_on_the_cpu_exits_0():
    out = subprocess.run([sys.executable, "-m", "ocflow_torch.tools.dryrun_multigpu",
                          "--nproc", "2", "--device", "cpu"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["ranks"] == 2 and res["replicas_equal"] and res["backend"] == "gloo"
    assert res["metric_max_rel"] <= 1e-6 and res["grad_max_rel"] <= 1e-5
