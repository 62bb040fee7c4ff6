"""Rank processes of the port's data-parallel CPU tests
(``tests/test_torch_parallel_*.py``), spawned by
``ocflow_torch.tools.dryrun_multigpu.spawn``: each joins a gloo group
through a ``file://`` store, runs one thread, computes, and saves its
readings to ``<out>/rank<r>.pt`` for the test to hold against the JAX
package or the single-process oracle. No JAX here: a rank imports torch and
the port only.
"""

from __future__ import annotations

import contextlib
import datetime
import hashlib
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
    raise, SimpleFlowNet's steps (BatchNorm, synced) over the ranks, and
    ``fit`` refusing a step not built for the mesh."""
    from ocflow_torch.models import SimpleFlowNet
    from ocflow_torch.train import config as config_lib
    from ocflow_torch.train import create_train_state, loop
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

    for name in ("unsupervised", "supervised"):
        res[f"bn_{name}"] = simple_step(name, {"_fast_mesh": mesh},
                                        parallel.shard_batch(smooth_batch(8, 2), mesh))
    res.update(_sharded_serving(mesh))
    res["supervised"] = supervised_step({"_fast_mesh": mesh},
                                        parallel.shard_batch(smooth_batch(7, 4), mesh))
    state = create_train_state(SimpleFlowNet(), 1e-4, device="cpu")
    inpaint = make_supervised_inpainting_step({"_fast_mesh": parallel.Mesh(0, 1)})
    cfg = config_lib.config_from_dict({"max_epochs": 1})
    res["fit_unsharded_step"] = _raises(
        lambda: loop.fit(cfg, state, *inpaint, [], [], mesh=mesh), NotImplementedError)
    _save(out, rank, res)


def simple_step(kind: str, hp: dict, batch: dict) -> dict:
    """One fp64 step of SimpleFlowNet (seeded from 0; fifteen train-mode
    BatchNorms) on ``batch``: the unsupervised step (occlusion-aware, both
    passes in train mode) or the supervised flow step (MSE). Its metrics and
    gradients."""
    from ocflow_torch.models import SimpleFlowNet
    from ocflow_torch.train import TrainState, make_supervised_flow_step
    from ocflow_torch.train import make_unsupervised_flow_step

    model = SimpleFlowNet(generator=torch.Generator().manual_seed(0)).double()
    state = TrainState(model, torch.optim.Adam(model.parameters(), lr=LR))
    if kind == "unsupervised":
        step, _ = make_unsupervised_flow_step({**STEP_HP, "model": "simple", **hp})
    else:
        step, _ = make_supervised_flow_step({"model": "simple", **hp})
    metrics = {k: float(v) for k, v in step(state, {k: v.double()
                                                    for k, v in batch.items()})[1].items()}
    return {"metrics": metrics,
            "grads": {n: p.grad.clone() for n, p in state.model.named_parameters()}}


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



# global-batch statistics (synced BatchNorm, the eager FlowNetCV's feature
# moments). Each case runs on this rank's block with ``mesh`` (in a rank) or
# on the whole batch with ``mesh`` None (one process); weights and batches
# come from seeds, fp64 unless named otherwise, and the blocks differ:
# other images, other occlusion and valid shares.


def shares_mask(rng, shape, shares) -> np.ndarray:
    """A ``[B, H, W, 1]`` 0/1 mask whose sample ``i`` is 1 with
    probability ``shares[i]``."""
    share = np.asarray(shares, np.float64)[:, None, None, None]
    return (rng.uniform(size=shape) < share).astype(np.float32)


def _block(batch: dict, mesh) -> dict:
    """This rank's block of a dict of numpy arrays, as tensors (the whole
    batch for ``mesh`` None)."""
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    return tensors if mesh is None else parallel.shard_batch(tensors, mesh)


def seeded_net(cls, seed: int, **kwargs):
    """``cls`` seeded from ``seed``, its BatchNorms perturbed from ``seed +
    100`` (``tests/test_torch_two_stage_step.py:seeded``)."""
    from ocflow_torch.bench import perturb_batchnorm

    model = cls(generator=torch.Generator().manual_seed(seed), **kwargs)
    perturb_batchnorm(model, torch.Generator().manual_seed(seed + 100))
    return model


def run_train(model, optimizer, step, batch, steps=1, args=()) -> dict:
    """``steps`` train steps of ``step`` on ``batch``: each step's metrics,
    gradients (summed over the ranks, recorded before the optimizer gates
    them) and ``state_dict`` after it."""
    from ocflow_torch.train import TrainState

    names = {id(p): n for n, p in model.named_parameters()}
    grads, inner = [], optimizer.step

    def snapped(*a, **k):
        grads.append({names[id(p)]: p.grad.clone() for g in optimizer.param_groups
                      for p in g["params"] if p.grad is not None})
        return inner(*a, **k)

    optimizer.step = snapped
    state = TrainState(model, optimizer)
    metrics, states = [], []
    for _ in range(steps):
        metrics.append({k: float(v) for k, v in step(state, *args, batch)[1].items()})
        states.append({k: v.clone() for k, v in model.state_dict().items()})
    return {"metrics": metrics, "grads": grads, "states": states, "state": states[-1]}


def bn_inputs(seed=0) -> dict:
    """``[8, 5, 6, 7]`` fp64 inputs whose samples have their own offsets and
    scales, a cotangent, and BatchNorm variables (scale, bias, running
    statistics)."""
    rng = np.random.default_rng(seed)
    shape = (8, 5, 6, 7)
    x = rng.normal(size=shape) * rng.uniform(0.5, 3.0, (8, 1, 1, 1)) \
        + rng.normal(size=(8, 5, 1, 1))
    return {"x": x, "g": rng.normal(size=shape), "weight": rng.uniform(0.5, 1.5, 5),
            "bias": rng.normal(0, 0.3, 5), "mean": rng.normal(0, 0.5, 5),
            "var": rng.uniform(0.5, 2.0, 5)}


def seeded_bn(inp: dict, dtype=torch.float64):
    """The port's BatchNorm with :func:`bn_inputs`' variables, train mode."""
    from ocflow_torch.models.common import BatchNorm

    bn = BatchNorm(inp["weight"].shape[0]).to(dtype)
    with torch.no_grad():
        for name, key in (("weight", "weight"), ("bias", "bias"), ("running_mean", "mean"),
                          ("running_var", "var")):
            getattr(bn, name).copy_(torch.from_numpy(inp[key]))
    return bn.train()


def bn_case(mesh) -> dict:
    """BatchNorm in train mode on the block of :func:`bn_inputs`: in fp64
    its output, the input's gradient for the cotangent, this rank's share
    of the scale's and bias's gradients, the running statistics (also under
    ``frozen_stats``); in fp32 under the bf16 policy (``apply_mixed``) on
    the inputs rounded to bf16, its output and running statistics."""
    from ocflow_torch.models.common import frozen_stats
    from ocflow_torch.models.precision import apply_mixed

    inp = bn_inputs()
    block = _block({"x": inp["x"], "g": inp["g"]}, mesh)
    out = {}
    for frozen in (False, True):
        bn = seeded_bn(inp)
        x = block["x"].clone().requires_grad_()
        with parallel.synced_stats(bn, mesh), \
                (frozen_stats(bn) if frozen else contextlib.nullcontext()):
            y = bn(x)
            (y * block["g"]).sum().backward()
        out["frozen" if frozen else "train"] = {
            "y": y.detach(), "dx": x.grad, "dweight": bn.weight.grad, "dbias": bn.bias.grad,
            "mean": bn.running_mean.clone(), "var": bn.running_var.clone(),
            "count": int(bn.num_batches_tracked)}
    bn = seeded_bn(inp, torch.float32)
    x16 = block["x"].float().bfloat16().float()
    with parallel.synced_stats(bn, mesh):
        y = apply_mixed(bn, x16)
    out["mixed"] = {"y": y.detach(), "mean": bn.running_mean.clone(),
                    "var": bn.running_var.clone()}
    return out


# the zoo: (network_type, registry family, key) of each supervised case,
# the unsupervised flownetc apart
ZOO = {"pwc": ("flow", "flow", "pwc"), "flownet": ("flow", "flow", "flownet"),
       "simple": ("flow", "flow", "simple"), "flowoccnetc": ("flow-occ", "flow_occ",
                                                             "flowoccnetc")}
# configs/longrun_synthetic.yaml's step hparams (tests/test_torch_unsup_steps.py),
# no compute_dtype: the step runs in the weights' dtype, fp64
UNSUP_HP = {"model": "flownetc", "occ_aware": True, "occ_method": "range_map",
            "occ_resolution": "full", "photo_weight": 4.0, "smooth1_weight": 0.5,
            "smooth2_weight": 0.0, "fast_forward": "both"}


def zoo_net(key: str):
    """The seeded init of a zoo case's net (seed 0), fp32."""
    from ocflow_torch.models import FlowNetC, FlowNetCV, registry

    gen = torch.Generator().manual_seed(0)
    if key == "pwc":
        return FlowNetCV(generator=gen)
    if key == "flownetc":
        return FlowNetC(generator=gen)
    _, family, name = ZOO[key]
    return registry.build(family, name, generator=gen)


def zoo_batch(key: str, b=2, h=64, w=128) -> dict:
    """The global batch of a zoo case: seeded frames (smooth ones for the
    unsupervised step), flow, and an occlusion mask over 50% of the first
    sample and 10% of the second."""
    from ocflow_torch.bench import smooth_images

    rng = np.random.default_rng(11)
    if key == "flownetc":
        coarse = torch.from_numpy(rng.uniform(-1, 1, (b, 6, h // 8, w // 8)))
        images = smooth_images(coarse).numpy()
    else:
        images = rng.uniform(-1, 1, (b, h, w, 6))
    return {"images": images, "flow": rng.normal(size=(b, h, w, 2)) * 3,
            "occ": shares_mask(rng, (b, h, w, 1), [0.5, 0.1][:b])}


def zoo_case(key: str, mesh) -> dict:
    """One fp64 Adam step of a zoo case on its block, after its eval step
    on the seeded weights (the eval metrics first)."""
    from ocflow_torch.train import TrainState, steps

    net = zoo_net(key).double()
    hp = {"model": ZOO.get(key, ("", "", key))[2], "_fast_mesh": mesh}
    if key == "flownetc":
        train_step, eval_step = steps.make_unsupervised_flow_step({**UNSUP_HP, **hp})
    else:
        factory = {"flow": steps.make_supervised_flow_step, "occ": steps.make_supervised_occ_step,
                   "flow-occ": steps.make_supervised_flow_occ_step}[ZOO[key][0]]
        train_step, eval_step = factory(hp)
    block = {k: v.double() for k, v in _block(zoo_batch(key), mesh).items()}
    evaluated = {k: float(v) for k, v in eval_step(
        TrainState(net, torch.optim.Adam(net.parameters(), lr=LR)), block).items()}
    res = run_train(net, torch.optim.Adam(net.parameters(), lr=LR), train_step, block)
    res["eval"] = evaluated
    return res


def inpaint_batch(kind: str, b=2, h=64, w=128) -> dict:
    """The supervised step's ``{images, flow, occ}`` or the stage step's
    ``{image, occ}``, the hole over 60% of the first sample and 15% of the
    second."""
    rng = np.random.default_rng(12)
    occ = shares_mask(rng, (b, h, w, 1), [0.6, 0.15])
    if kind == "inpaint_sup":
        return {"images": rng.uniform(-1, 1, (b, h, w, 6)),
                "flow": rng.normal(size=(b, h, w, 2)) * 3, "occ": occ}
    return {"image": rng.uniform(-1, 1, (b, h, w, 3)), "occ": occ}


def inpaint_case(kind: str, mesh) -> dict:
    """One fp64 Adam step (lr 1e-3) of the supervised or the stage
    inpainting step on InpaintingNet (seed 0, BatchNorms perturbed)."""
    from ocflow_torch.models import InpaintingNet
    from ocflow_torch.train import make_inpainting_stage_step, make_supervised_inpainting_step

    net = seeded_net(InpaintingNet, 0).double()
    factory = (make_supervised_inpainting_step if kind == "inpaint_sup"
               else make_inpainting_stage_step)
    step, _ = factory({"loss_type": "pixel-wise", "_fast_mesh": mesh})
    block = {k: v.double() for k, v in _block(inpaint_batch(kind), mesh).items()}
    return run_train(net, torch.optim.Adam(net.parameters(), lr=1e-3), step, block)


GAN_LR = 0.05


def gan_nets():
    """The projected gated generator with remat (seed 1, BatchNorms
    perturbed, ``gamma`` 0.5) and its discriminator (seed 3), fp32."""
    from ocflow_torch.bench import perturb_batchnorm
    from ocflow_torch.models import InpaintSADiscriminator, registry

    gen = registry.build("inpainting", "gated", remat=True,
                         generator=torch.Generator().manual_seed(1))
    perturb_batchnorm(gen, torch.Generator().manual_seed(101))
    with torch.no_grad():
        gen.refine_attn.gamma.fill_(0.5)
    return gen, InpaintSADiscriminator(generator=torch.Generator().manual_seed(3))


def gan_batch(b=2, h=64, w=128) -> dict:
    rng = np.random.default_rng(13)
    return {"image": rng.uniform(-1, 1, (b, h, w, 3)),
            "occ": shares_mask(rng, (b, h, w, 1), [0.5, 0.2])}


def gan_case(mesh) -> dict:
    """One fp64 GAN step (SGD at ``GAN_LR`` for both nets): the metrics,
    both nets' gradients (each summed over the ranks) and ``state_dict``s
    after (the generator's statistics, the discriminator's ``u`` and
    ``sigma``)."""
    from ocflow_torch.train import TrainState, make_gan_inpainting_step

    gen, dis = (m.double() for m in gan_nets())
    states = (TrainState(gen, torch.optim.SGD(gen.parameters(), lr=GAN_LR)),
              TrainState(dis, torch.optim.SGD(dis.parameters(), lr=GAN_LR)))
    grads = {}
    for name, s in zip(("gen", "dis"), states):
        inner = s.optimizer.step

        def snapped(*a, _m=s.model, _n=name, _inner=inner, **k):
            grads[_n] = {n: p.grad.clone() for n, p in _m.named_parameters()}
            return _inner(*a, **k)

        s.optimizer.step = snapped
    step = make_gan_inpainting_step({"loss_type": "pixel-wise", "_fast_mesh": mesh})
    block = {k: v.double() for k, v in _block(gan_batch(), mesh).items()}
    _, metrics = step(states, block)
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads,
            "gen": {k: v.clone() for k, v in gen.state_dict().items()},
            "dis": {k: v.clone() for k, v in dis.state_dict().items()}}


def two_stage_batch(with_flow: bool, b=2, h=64, w=64) -> dict:
    rng = np.random.default_rng(14)
    batch = {"images": rng.uniform(-1, 1, (b, h, w, 6)),
             "occ": shares_mask(rng, (b, h, w, 1), [0.5, 0.1])}
    if with_flow:
        batch["flow"] = rng.normal(size=(b, h, w, 2)) * 3
    return batch


TWO_STAGE_HP = {"smoothness_weight": 0.5, "reconst_weight": 1.0}
GC_HP = {"loss_type": "pixel-wise", "photo_weight": 1.0, "reconst_weight": 1.0,
         "smooth1_weight": 0.5, "pixelwise_weight": 1.0}
GC_LR, GC_INPAINT_LR, GC_UNFREEZE = 1e-3, 1e-4, 1


def two_stage_nets():
    """SimpleOcclusionNet (seed 2), the frozen SimpleFlowNet (seed 3) and
    the frozen InpaintingNet the JAX step takes (seed 4), BatchNorms
    perturbed, fp32."""
    from ocflow_torch.models import InpaintingNet, SimpleFlowNet, SimpleOcclusionNet

    return (seeded_net(SimpleOcclusionNet, 2), seeded_net(SimpleFlowNet, 3),
            seeded_net(InpaintingNet, 4))


def gc_pair():
    """The GC pair ``{'occ': SimpleOcclusionNet (seed 2), 'inpaint':
    InpaintingNet (seed 4)}``, BatchNorms perturbed, fp32."""
    from ocflow_torch.models import InpaintingNet, SimpleOcclusionNet

    return torch.nn.ModuleDict({"occ": seeded_net(SimpleOcclusionNet, 2),
                                "inpaint": seeded_net(InpaintingNet, 4)})


def two_stage_case(kind: str, mesh) -> dict:
    """Two fp64 steps: the TwoStageModel step (Adam at 1e-3 over the
    occlusion net, the flow net frozen) or the GC step (the gated Adam, the
    inpainter gated for ``GC_UNFREEZE`` updates: one step in each phase)."""
    from ocflow_torch.train import steps_two_stage as st

    block = {k: v.double() for k, v in _block(two_stage_batch(kind == "gc"), mesh).items()}
    if kind == "gc":
        pair = gc_pair().double()
        opt = st.make_two_stage_gc_optimizer(pair, GC_LR, GC_INPAINT_LR, GC_UNFREEZE)
        step, _ = st.make_two_stage_gc_step({**GC_HP, "_fast_mesh": mesh})
        return run_train(pair, opt, step, block, steps=2)
    occ, flow, _ = (m.double() for m in two_stage_nets())
    step, _ = st.make_two_stage_step({**TWO_STAGE_HP, "_fast_mesh": mesh})
    res = run_train(occ, torch.optim.Adam(occ.parameters(), lr=1e-3), step, block, steps=2,
                    args=({"flow": flow},))
    res["frozen_unchanged"] = all(
        torch.equal(v, w) for v, w in zip(flow.state_dict().values(),
                                          two_stage_nets()[1].double().state_dict().values()))
    return res


JOINT_OCC_SCALE = 100.0


def joint_pair(occ_scale=1.0):
    """FlowOccNetCV (seed 0; its last occlusion head times ``occ_scale``)
    and InpaintingNet (seed 1, BatchNorms perturbed), fp32."""
    from ocflow_torch.models import FlowOccNetCV, InpaintingNet

    flow_occ = FlowOccNetCV(generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        flow_occ.predict_occ2[0].weight.mul_(occ_scale)
    return torch.nn.ModuleDict({"flow_occ": flow_occ, "inpaint": seeded_net(InpaintingNet, 1)})


def joint_batch(b=2, h=64, w=64) -> dict:
    """KITTI-like: the flow valid on 80% of the first sample and 40% of the
    second, the occlusion on 30% and 10%."""
    rng = np.random.default_rng(15)
    valid = shares_mask(rng, (b, h, w, 1), [0.8, 0.4])
    return {"images": rng.uniform(-1, 1, (b, h, w, 6)),
            "flow": rng.uniform(-5, 5, (b, h, w, 2)) * valid, "valid": valid,
            "occ": shares_mask(rng, (b, h, w, 1), [0.3, 0.1])}


def joint_case(kind: str, mesh) -> dict:
    """One joint step (Adam at 1e-4) of :func:`joint_pair`, the occlusion
    head x100 (``tests/test_torch_parallel_joint.py`` says why):
    ``joint_fp32``, ``joint_fp64`` or ``joint_bf16`` (``dtype:
    bfloat16``)."""
    from ocflow_torch.train.steps_joint import make_joint_step

    dt = torch.float64 if kind == "joint_fp64" else torch.float32
    pair = joint_pair(JOINT_OCC_SCALE).to(dt)
    step, _ = make_joint_step({"dtype": "bfloat16" if kind == "joint_bf16" else None,
                               "_fast_mesh": mesh})
    block = {k: v.to(dt) for k, v in _block(joint_batch(), mesh).items()}
    return run_train(pair, torch.optim.Adam(pair.parameters(), lr=1e-4), step, block)


SYNC_CASES = {"bn": bn_case, **{k: (lambda m, _k=k: zoo_case(_k, m)) for k in (*ZOO, "flownetc")},
              **{k: (lambda m, _k=k: inpaint_case(_k, m)) for k in ("inpaint_sup",
                                                                    "inpaint_stage")},
              "gan": gan_case,
              **{k: (lambda m, _k=k: two_stage_case(_k, m)) for k in ("two_stage", "gc")},
              **{k: (lambda m, _k=k: joint_case(_k, m)) for k in ("joint_fp32", "joint_fp64",
                                                                  "joint_bf16")}}


# the readings that hold a whole net (gradients, state_dicts): rank 0 saves
# them, every other rank their digest, which the tests hold equal to rank
# 0's (FlowNetC's fp64 gradients and state are 0.6 GB a rank)
WHOLE_NETS = ("grads", "states", "state", "gen", "dis")


def digest(tree) -> str:
    """sha256 of a tensor tree's names, dtypes, shapes and bytes."""
    h = hashlib.sha256()

    def walk(node, name=""):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{name}.{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{name}.{i}")
        else:
            t = node.detach().cpu().contiguous()
            h.update(f"{name}:{t.dtype}:{tuple(t.shape)}".encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())

    walk(tree)
    return h.hexdigest()


def sync_rank(rank: int, nproc: int, store: str, out: str, names) -> None:
    """The :data:`SYNC_CASES` ``names`` on this rank's blocks, each case's
    readings saved (beyond rank 0, the :data:`WHOLE_NETS` ones as digests)."""
    mesh = _join(rank, nproc, store)
    res = {}
    for name in names:
        case = SYNC_CASES[name](mesh)
        if rank:
            case = {k: digest(v) if k in WHOLE_NETS else v for k, v in case.items()}
        res[name] = case
    _save(out, rank, res)


def load_ranks(out, world: int) -> list:
    """Every rank's saved readings, the files removed once read."""
    per_rank = []
    for r in range(world):
        path = os.path.join(out, f"rank{r}.pt")
        per_rank.append(torch.load(path, weights_only=False))
        os.remove(path)
    return per_rank


def same_nets(per_rank: list, key: str = "state") -> bool:
    """Whether every rank's :data:`WHOLE_NETS` reading ``key`` (rank 0's
    tensors, the others' digests) is rank 0's bit for bit."""
    first = digest(per_rank[0][key])
    return all(r[key] == first for r in per_rank[1:])


def sync_single(name: str) -> dict:
    """A :data:`SYNC_CASES` case in this process on the whole batch, on one
    thread as the ranks run (a CPU conv sums in another order on more)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return SYNC_CASES[name](None)
    finally:
        torch.set_num_threads(threads)


def bn_cli_rank(rank: int, nproc: int, store: str, out: str, runs: dict) -> None:
    """The trainer CLIs on a group joined beforehand, as ``cli_rank``:
    ``runs`` maps a name to ``(cli, config file)``, ``cli`` ``unsupervised``
    or ``supervised``. Saves each run's test metrics."""
    _join(rank, nproc, store)
    _save(out, rank, {"results": {name: run_cli(cli, path)
                                  for name, (cli, path) in runs.items()}})


def run_cli(cli: str, path: str) -> dict:
    """``main`` of a trainer CLI on ``path`` on the CPU (gloo under a group);
    its test metrics."""
    from ocflow_torch import train_unsupervised
    from ocflow_torch.train import __main__ as train_supervised

    main = {"unsupervised": train_unsupervised.main, "supervised": train_supervised.main}[cli]
    return main(["--config", path, "--device", "cpu", "--dist_backend", "gloo"])
