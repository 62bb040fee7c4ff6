"""One data-parallel training step over several ranks, held against one
process (port of the JAX package's ``dryrun_multichip``).

    python -m ocflow_torch.tools.dryrun_multigpu --nproc N [--device cpu] \\
        [--backend gloo|nccl] [--batch B] [--size H W]

Spawns ``N`` ranks joined through a ``file://`` store in a temporary
directory (``nccl`` by default on CUDA, which wants a GPU per rank; ``gloo``
on the CPU and for ranks that share a GPU). Each runs one occlusion-aware
FlowNetCV step (range-map occlusion, photo 4.0, smooth1 0.5, fp32, the
fused pair) on its block of a global batch of ``B`` (default ``2 N``)
distinct seeded pairs at ``H x W`` (default 64 x 64), then one more. Rank 0
also runs the step's single-process oracle on the whole batch (the forward
pair per block, concatenated, then the losses on the whole batch:
``hparams['_blocks'] = N``) from the same weights, and the run asserts:

- the loss and every metric equal the oracle's (1e-6 relative on the CPU,
  1e-5 on CUDA);
- every gradient tensor equals the oracle's within 1e-5 (CPU) / 1e-4 (CUDA)
  of its max|grad|;
- the ranks' parameters are equal bit for bit after each Adam step.

On CUDA both steps run under deterministic algorithms (cuDNN's, and
PyTorch's for the range map's ``index_add_``): with atomics two runs of the
same fp32 step differ by up to ~8e-3 of max|grad| in a bias, more than the
sharding moves it. Prints one JSON line (rank 0's readings); exits 1 if a rank fails. The
kernels are built before the ranks start (CUDA), so no two ranks build at
once. Runs on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import copy
import datetime
import json
import multiprocessing.connection
import os
import tempfile
import time

import numpy as np
import torch
import torch.multiprocessing as mp

HP = {"model": "pwc", "occ_aware": True, "occ_method": "range_map",
      "photo_weight": 4.0, "smooth1_weight": 0.5, "smooth2_weight": 0.0,
      "fast_forward": "both", "compute_dtype": "float32"}
LR = 1e-4
# (metric relative, gradient over max|grad|) per device type
TOL = {"cpu": (1e-6, 1e-5), "cuda": (1e-5, 1e-4)}


def spawn(fn, nproc: int, *args, timeout: float = 600.0) -> None:
    """``fn(rank, nproc, store, *args)`` in ``nproc`` spawned processes
    (``store``: a ``file://`` address for ``parallel.initialize``). Waits
    for all; when one fails the others are stopped, and it raises, as it
    does past ``timeout`` seconds."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store = f"file://{tmp}/store"
        procs = [ctx.Process(target=fn, args=(r, nproc, store, *args)) for r in range(nproc)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            alive = list(procs)
            while alive:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"ranks still running after {timeout} s")
                multiprocessing.connection.wait([p.sentinel for p in alive], left)
                alive = [p for p in alive if p.is_alive()]
                if any(p.exitcode for p in procs if not p.is_alive()):
                    break
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"rank exit codes {codes}")


def make_batch(batch: int, height: int, width: int, seed: int = 0) -> dict:
    """``batch`` distinct seeded pairs (``bench.smooth_images``) with a
    ground-truth flow (a metric only)."""
    from ocflow_torch.bench import smooth_images

    rng = np.random.default_rng(seed)
    coarse = torch.from_numpy(rng.uniform(-1, 1, (batch, 6, height // 8, width // 8)))
    return {"images": smooth_images(coarse).float(),
            "flow": torch.from_numpy(rng.normal(size=(batch, height, width, 2))).float()}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def dryrun_step(mesh, device: torch.device, batch: dict, hparams: dict = HP) -> dict:
    """The checks of the module docstring on this rank (every rank calls
    it); returns rank 0's readings. Raises on every rank if one fails."""
    from ocflow_torch import parallel
    from ocflow_torch.models import FlowNetCV
    from ocflow_torch.train import create_train_state, make_unsupervised_flow_step

    metric_tol, grad_tol = TOL[device.type]
    if device.type == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
    model = FlowNetCV(generator=torch.Generator().manual_seed(0))
    oracle_model = copy.deepcopy(model)
    state = create_train_state(model, LR, device=device)
    parallel.replicated(state.model, mesh)
    step, _ = make_unsupervised_flow_step({**hparams, "_fast_mesh": mesh})
    block = {k: v.to(device) for k, v in parallel.shard_batch(batch, mesh).items()}
    metrics = {k: float(v) for k, v in step(state, block)[1].items()}
    grads = {n: p.grad.detach().clone() for n, p in state.model.named_parameters()}
    parallel.check_replicated(state.model, mesh)

    failures, out = [], {"ranks": mesh.size, "device": str(device), "metrics": metrics}
    if mesh.rank == 0:
        ostate = create_train_state(oracle_model, LR, device=device)
        # alone in this process (a mesh of one), the forward per block
        ostep, _ = make_unsupervised_flow_step(
            {**hparams, "_blocks": mesh.size, "_fast_mesh": parallel.Mesh(0, 1)})
        want = {k: float(v) for k, v in
                ostep(ostate, {k: v.to(device) for k, v in batch.items()})[1].items()}
        metric_err = {k: _rel(metrics[k], want[k]) for k in want}
        grad_err = {n: ((grads[n] - p.grad).abs().max()
                        / p.grad.abs().max().clamp_min(1e-30)).item()
                    for n, p in ostate.model.named_parameters()}
        worst = max(grad_err, key=grad_err.get)
        out.update(oracle_metrics=want, metric_max_rel=max(metric_err.values()),
                   grad_max_rel=grad_err[worst], grad_worst=worst,
                   tolerances={"metric_rel": metric_tol, "grad_rel": grad_tol})
        if set(metrics) != set(want) or max(metric_err.values()) > metric_tol:
            failures.append(f"metrics {metrics} vs the oracle's {want}")
        if grad_err[worst] > grad_tol:
            failures.append(f"gradient {worst}: {grad_err[worst]:.3e} of max|grad|")
        del ostate
    flag = torch.tensor([float(bool(failures))], device=device)
    if mesh.all_reduce(flag).item():
        raise AssertionError("; ".join(failures) or "rank 0 failed a check")
    out["second_step"] = {k: float(v) for k, v in step(state, block)[1].items()}
    parallel.check_replicated(state.model, mesh)
    out["replicas_equal"] = True
    return out


def _rank(rank: int, nproc: int, store: str, opts: dict) -> None:
    from ocflow_torch import parallel

    if opts["device"] == "cpu":
        torch.set_num_threads(1)
    parallel.initialize(store, nproc, rank, backend=opts["backend"], device=opts["device"],
                        timeout=datetime.timedelta(seconds=opts["timeout"]))
    try:
        device = parallel.local_device(opts["device"])
        mesh = parallel.make_mesh(device=device)
        batch = make_batch(opts["batch"], *opts["size"])
        res = dryrun_step(mesh, device, batch)
        if rank == 0:
            with open(opts["out"], "w") as f:
                json.dump(res, f)
    finally:
        torch.distributed.destroy_process_group()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="default nccl on CUDA (a GPU per rank), gloo on the CPU")
    ap.add_argument("--batch", type=int, default=None, help="global batch (default 2 nproc)")
    ap.add_argument("--size", type=int, nargs=2, default=(64, 64), metavar=("H", "W"))
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        from ocflow_torch import resolve_device
        from ocflow_torch.kernels import _build

        resolve_device("cuda")
        _build.build_all()
    backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.json")
        opts = {"device": args.device, "backend": backend, "out": out,
                "batch": args.batch or 2 * args.nproc, "size": tuple(args.size),
                "timeout": args.timeout}
        spawn(_rank, args.nproc, opts, timeout=args.timeout)
        with open(out) as f:
            res = json.load(f)
    res.update(backend=backend, seconds=time.perf_counter() - t0)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    try:
        main()
    except (RuntimeError, AssertionError, TimeoutError) as e:
        raise SystemExit(f"dryrun_multigpu: {e}") from e
