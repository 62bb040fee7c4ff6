"""Rank processes of the port's data-parallel CPU tests
(``tests/test_torch_parallel_*.py``), spawned by
``ocflow_torch.tools.dryrun_multigpu.spawn``: each joins a gloo group
through a ``file://`` store, runs one thread, computes, and saves its
readings to ``<out>/rank<r>.pt`` for the test to hold against the JAX
package or the single-process oracle. No JAX here: a rank imports torch and
the port only.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch

from ocflow_torch import parallel

# tests/test_torch_step.py's hparams: FlowNetCV, occlusion-aware, fp32
STEP_HP = {"model": "pwc", "occ_aware": True, "occ_method": "range_map",
           "photo_weight": 4.0, "smooth1_weight": 0.5, "smooth2_weight": 0.0,
           "fast_forward": "both"}
# the distinct-example cases: the main path, and a ground-truth occlusion
# mask whose visible share differs between the halves (charbonnier, census)
DISTINCT = {"occ_aware": {},
            "with_occ": {"occ_aware": False, "with_occ": True},
            "with_occ_census": {"occ_aware": False, "with_occ": True, "photo_loss": "census"}}
LR = 1e-4


def _join(rank: int, nproc: int, store: str) -> parallel.Mesh:
    torch.set_num_threads(1)
    parallel.initialize(store, nproc, rank, backend="gloo", device="cpu",
                        timeout=datetime.timedelta(seconds=120))
    return parallel.make_mesh(device="cpu")


def _save(out: str, rank: int, result: dict) -> None:
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def _raises(fn, exc) -> str:
    try:
        fn()
    except exc as e:
        return str(e)
    return ""


def smooth_batch(seed: int, b: int, h: int = 64, w: int = 128) -> dict:
    """``tests/test_torch_step.py:smooth_batch``, as tensors."""
    from ocflow_torch.bench import smooth_images

    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(rng.uniform(-1, 1, (b, 6, h // 8, w // 8)))
    return {"images": smooth_images(coarse).float(),
            "flow": torch.from_numpy(rng.normal(size=(b, h, w, 2)).astype(np.float32)),
            "occ": torch.from_numpy((rng.uniform(size=(b, h, w, 1)) > 0.8)
                                    .astype(np.float32))}


def distinct_batch() -> dict:
    """Four distinct pairs; the ground-truth occlusion covers about 60% of
    the first two and 10% of the last two, so the ranks' visible shares
    differ and a per-rank ratio loss is not the global one."""
    batch = smooth_batch(3, 4)
    rng = np.random.default_rng(4)
    share = np.array([0.6, 0.6, 0.1, 0.1])[:, None, None, None]
    batch["occ"] = torch.from_numpy(
        (rng.uniform(size=batch["occ"].shape) < share).astype(np.float32))
    return batch


def identical_batch() -> dict:
    """One pair twice: per-rank feature normalization equals the global."""
    one = smooth_batch(1, 1)
    return {k: torch.cat([v, v]) for k, v in one.items()}


def run_steps(hp: dict, batch: dict, steps: int, model=None) -> dict:
    """``steps`` Adam steps of the unsupervised step on ``batch`` from the
    seeded FlowNetCV: each step's metrics, the first step's gradients, the
    parameters after the last."""
    from ocflow_torch.models import FlowNetCV
    from ocflow_torch.train import create_train_state, make_unsupervised_flow_step

    model = model or FlowNetCV(generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, LR, device="cpu")
    step, _ = make_unsupervised_flow_step(hp)
    metrics, grads = [], None
    for _ in range(steps):
        metrics.append({k: float(v) for k, v in step(state, batch)[1].items()})
        if grads is None:
            grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
    return {"metrics": metrics, "grads": grads,
            "params": {n: p.detach().clone() for n, p in state.model.named_parameters()}}


def step_rank(rank: int, nproc: int, store: str, out: str, identical: bool) -> None:
    """The FlowNetCV step over the ranks: on identical examples (one step),
    or on the distinct cases (two steps each)."""
    mesh = _join(rank, nproc, store)
    hp = {**STEP_HP, "_fast_mesh": mesh}
    if identical:
        res = {"identical": run_steps(hp, parallel.shard_batch(identical_batch(), mesh), 1)}
    else:
        block = parallel.shard_batch(distinct_batch(), mesh)
        res = {case: run_steps({**hp, **extra}, block, 2) for case, extra in DISTINCT.items()}
    _save(out, rank, res)


def spatial_rank(rank: int, nproc: int, store: str, out: str, inputs: dict) -> None:
    """The spatial cost volume (d = 2, 4) and warp (both ``align_corners``)
    on this rank's rows of the NCHW ``inputs``; each cost volume's gradient
    for a seeded cotangent against the single-process gradient's rows; the
    halo rows of a row-numbered map."""
    from ocflow_torch.kernels.cost_volume import cost_volume

    mesh = _join(rank, nproc, store)
    f1, f2, img, flow = (inputs[k] for k in ("f1", "f2", "img", "flow"))
    rows = parallel.batch_sharding(parallel.Mesh(rank, nproc), f1.shape[2])
    res = {"rows": (rows.start, rows.stop)}
    for d in (2, 4):
        a = f1[:, :, rows].clone().requires_grad_()
        b = f2[:, :, rows].clone().requires_grad_()
        out_d = parallel.spatial_cost_volume(a, b, d, mesh)
        g = torch.randn((f1.shape[0], (2 * d + 1) ** 2, *f1.shape[2:]),
                        generator=torch.Generator().manual_seed(d))
        (out_d * g[:, :, rows]).sum().backward()
        fa, fb = f1.clone().requires_grad_(), f2.clone().requires_grad_()
        (cost_volume(fa, fb, d) * g).sum().backward()
        res[f"cv{d}"] = out_d.detach()
        res[f"cv{d}_grad_err"] = max(
            ((mine - whole.grad[:, :, rows]).abs().max() / whole.grad.abs().max()).item()
            for mine, whole in ((a.grad, fa), (b.grad, fb)))
    img_rows = parallel.batch_sharding(parallel.Mesh(rank, nproc), img.shape[2])
    for ac in (True, False):
        res[f"warp_{ac}"] = parallel.spatial_warp(img[:, :, img_rows], flow[:, :, img_rows],
                                                  2, mesh, align_corners=ac)
    numbered = torch.arange(f1.shape[2], dtype=torch.float32).view(1, 1, -1, 1)
    res["halo"] = parallel.halo_exchange(numbered[:, :, rows], 2, mesh)
    _save(out, rank, res)


def dist_rank(rank: int, nproc: int, store: str, out: str) -> None:
    """The collectives, the replicas' broadcast and check, the meshes that
    raise, and the steps that refuse a BatchNorm net or a mesh they were
    not built for."""
    from ocflow_torch.models import SimpleFlowNet
    from ocflow_torch.train import config as config_lib
    from ocflow_torch.train import create_train_state, loop, make_supervised_flow_step
    from ocflow_torch.train import make_unsupervised_flow_step
    from ocflow_torch.train.steps_inpainting import make_supervised_inpainting_step

    mesh = _join(rank, nproc, store)
    res = {"again": parallel.initialize(), "world": parallel.world_size(),
           "main": parallel.is_main_process(), "shard_info": parallel.local_shard_info()}
    res["means"] = parallel.global_mean_metrics({"b": 2.0 * rank, "a": rank + 1.0}, mesh)
    res["gathered"] = mesh.all_gather(torch.tensor([[rank, 10 * rank]]))
    res["summed"] = mesh.all_reduce(torch.tensor([rank + 1.0]))
    res["broadcast"] = mesh.broadcast(torch.tensor([rank + 5.0]))
    res["exchange"] = mesh.exchange(torch.tensor([100.0 + rank]), torch.tensor([200.0 + rank]))
    res["bad_shape"] = _raises(lambda: parallel.make_mesh((nproc + 1,)), ValueError)
    res["two_axes"] = _raises(lambda: parallel.make_mesh((1, nproc)), ValueError)
    res["ragged"] = _raises(lambda: parallel.shard_batch(torch.zeros(nproc + 1), mesh),
                            ValueError)

    net = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(net.weight, float(rank))
    parallel.replicated(net, mesh)
    res["replicated"] = net.weight.detach().clone()
    parallel.check_replicated(net, mesh)
    with torch.no_grad():
        net.weight[0, 0] += rank
    res["diverged"] = _raises(lambda: parallel.check_replicated(net, mesh), RuntimeError)

    batch = {"images": torch.zeros(1, 64, 64, 6), "flow": torch.zeros(1, 64, 64, 2)}
    state = create_train_state(SimpleFlowNet(), 1e-4, device="cpu")
    hp = {"model": "simple", "_fast_mesh": mesh}
    for name, make in (("unsupervised", make_unsupervised_flow_step),
                       ("supervised", make_supervised_flow_step)):
        train_step, eval_step = make(hp)
        res[f"bn_{name}"] = _raises(lambda: train_step(state, batch), NotImplementedError)
        res[f"bn_{name}_eval"] = _raises(lambda: eval_step(state, batch),  # noqa: B023
                                         NotImplementedError)
    res.update(_sharded_serving(mesh))
    res["supervised"] = supervised_step({"_fast_mesh": mesh},
                                        parallel.shard_batch(smooth_batch(7, 4), mesh))
    inpaint = make_supervised_inpainting_step({})
    cfg = config_lib.config_from_dict({"max_epochs": 1})
    res["fit_unsharded_step"] = _raises(
        lambda: loop.fit(cfg, state, *inpaint, [], [], mesh=mesh), NotImplementedError)
    _save(out, rank, res)


def supervised_step(hp: dict, batch: dict) -> dict:
    """One supervised flow step (MSE) of PWCNet (no BatchNorm, no batch-wide
    normalization) seeded from 0: its metrics and gradients."""
    from ocflow_torch.models import PWCNet
    from ocflow_torch.train import create_train_state, make_supervised_flow_step

    state = create_train_state(PWCNet(generator=torch.Generator().manual_seed(0)), LR,
                               device="cpu")
    step, _ = make_supervised_flow_step({"model": "pwcnet", **hp})
    metrics = {k: float(v) for k, v in step(state, batch)[1].items()}
    return {"metrics": metrics,
            "grads": {n: p.grad.clone() for n, p in state.model.named_parameters()}}


def _sharded_serving(mesh) -> dict:
    """``fast_apply_sharded`` and ``fast_apply_pair_sharded`` (fp32, the
    plain versions on the CPU) against the single-process forwards of each
    block: the largest difference of this rank's block and of the gathered
    batch; the gradient form refusing ``gather``."""
    from ocflow_torch.models import FlowNetCV, pwc_fast

    model = FlowNetCV(generator=torch.Generator().manual_seed(0))
    x = smooth_batch(6, 2 * mesh.size, 64, 64)["images"]
    blocks = [parallel.batch_sharding(parallel.Mesh(r, mesh.size), x.shape[0])
              for r in range(mesh.size)]

    def diffs(got, refs):
        mine = max((g - r).abs().max().item()
                   for g, r in zip(_flat(got[0]), _flat(refs[mesh.rank])))
        whole = [torch.cat(t) for t in zip(*(_flat(r) for r in refs))]
        gathered = max((g - w).abs().max().item() for g, w in zip(_flat(got[1]), whole))
        return mine, gathered

    with torch.no_grad():
        serve = diffs([pwc_fast.fast_apply_sharded(model, x, mesh, device="cpu", gather=g)
                       for g in (False, True)],
                      [pwc_fast.fast_apply(model, x[s], device="cpu") for s in blocks])
        pair = diffs([pwc_fast.fast_apply_pair_sharded(model, x, mesh, device="cpu",
                                                       gather=g) for g in (False, True)],
                     [pwc_fast.fast_apply_pair(model, x[s], device="cpu") for s in blocks])
    refused = _raises(lambda: pwc_fast.fast_apply_sharded(model, x, mesh, device="cpu",
                                                          diff=True, gather=True), ValueError)
    return {"sharded_serving": serve, "sharded_pair": pair, "diff_gather": refused}


def _flat(pairs) -> list:
    """The flow tensors of a forward's output or of a pair's, in order."""
    return [t for p in pairs for t in (p if isinstance(p, tuple) else (p,))]


def fit_rank(rank: int, nproc: int, store: str, out: str, raw: dict) -> None:
    """``fit`` over the ranks: PWCNet (no BatchNorm, no batch-wide
    normalization) seeded from 0, the config ``raw``; rank 0 writes the CSV
    and the checkpoints. Saves the final step and parameters."""
    from ocflow_torch.models import PWCNet
    from ocflow_torch.train import config as config_lib
    from ocflow_torch.train import create_train_state, loop, make_unsupervised_flow_step

    mesh = _join(rank, nproc, store)
    cfg = config_lib.config_from_dict(raw)
    train, val, _ = loop.make_loaders(cfg, "cpu")
    state = create_train_state(PWCNet(generator=torch.Generator().manual_seed(0)),
                               cfg.learning_rate, device="cpu")
    train_step, eval_step = make_unsupervised_flow_step(cfg.as_hparams())
    state = loop.fit(cfg, state, train_step, eval_step, train, val)
    _save(out, rank, {"step": state.step, "blocks": (train.block, val.block),
                      "params": {n: p.detach().clone()
                                 for n, p in state.model.named_parameters()}})


def cli_rank(rank: int, nproc: int, store: str, out: str, configs: dict) -> None:
    """The trainer CLIs on a rank of a group joined beforehand (their
    ``initialize`` finds it running): ``configs`` maps ``unsupervised`` /
    ``supervised`` to a config file. Saves each run's test metrics."""
    from ocflow_torch import train_unsupervised
    from ocflow_torch.train import __main__ as train_supervised

    _join(rank, nproc, store)
    mains = {"unsupervised": train_unsupervised.main, "supervised": train_supervised.main}
    results = {name: mains[name](["--config", path, "--device", "cpu",
                                  "--dist_backend", "gloo"])
               for name, path in configs.items()}
    _save(out, rank, {"results": results})
