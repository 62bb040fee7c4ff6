"""The training loop (port of ``ocflow_tpu/train/loop.py``): epochs, seeded
splits, validation, the metrics sinks (TensorBoard, CSV), the validation
panels, the best checkpoint on ``monitored_loss`` and early stopping.

The device is the train state's: the loaders generate and keep their data
there (``make_loaders(cfg, device)``). Over several processes (``mesh``,
default ``parallel.default_mesh(cfg.mesh_shape)``: a mesh over every
process when more than one runs) each rank loads its block of every global
batch of ``batch_size``, the state starts from rank 0's parameters, the
steps (built for the same mesh) return global-batch metrics, the val means
go through ``global_mean_metrics`` so every rank takes the same early-stop
decision, and only the main process writes TensorBoard, the CSV, the panels
and the checkpoints. After the run the replicas are checked equal: every
model of the state (a GAN run's generator and discriminator, a pipeline's
``ModuleDict``), parameters and buffers (BatchNorm statistics, spectral-norm
vectors).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch

from ocflow_torch import data as data_lib
from ocflow_torch import parallel
from ocflow_torch.train.config import Config
from ocflow_torch.train.state import state_device
from ocflow_torch.utils.checkpoint import CheckpointManager
from ocflow_torch.utils.png import encode_png, write_png
from ocflow_torch.utils.profiling import StepTimer


class SummaryLogger:
    """TensorBoard scalars and images through ``torch.utils.tensorboard``;
    a no-op where TensorBoard does not import. Images go in as the PNG
    writer's bytes (``add_image`` would need PIL)."""

    def __init__(self, log_dir: str, enabled: bool = True):
        self._writer = None
        if not enabled:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._writer = SummaryWriter(log_dir)

    def scalar(self, tag: str, value, step: int):
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), step)

    def image(self, tag: str, img, step: int):
        """A uint8 ``[H, W, 3]`` image."""
        if self._writer is not None:
            from tensorboard.compat.proto.summary_pb2 import Summary

            h, w, c = img.shape
            png = Summary.Image(height=h, width=w, colorspace=c,
                                encoded_image_string=encode_png(img))
            self._writer._get_file_writer().add_summary(
                Summary(value=[Summary.Value(tag=tag, image=png)]), step)

    def flush(self):
        if self._writer is not None:
            self._writer.flush()

    def close(self):
        if self._writer is not None:
            self._writer.close()


class CsvLogger:
    """Metric rows appended to a CSV file (a no-op when ``path`` is '').

    One header from the first row's keys; later rows are aligned to it
    (missing keys give '', extra keys extend the header in place), so train
    and val rows with different metrics share one file through the
    ``phase`` column. The bytes equal the JAX package's ``CsvLogger``'s."""

    def __init__(self, path: str):
        self._path = path or None
        self._keys = None

    def row(self, phase: str, step: int, epoch: int, metrics: dict):
        if self._path is None:
            return
        vals = {k: float(v) for k, v in metrics.items()}
        if self._keys is None:
            self._keys = sorted(vals)
            new = not os.path.exists(self._path)
            if new:
                d = os.path.dirname(self._path)
                if d:
                    os.makedirs(d, exist_ok=True)
            with open(self._path, "a") as f:
                if new:
                    f.write("phase,step,epoch," + ",".join(self._keys) + "\n")
        elif not set(vals) <= set(self._keys):
            self._keys = sorted(set(self._keys) | set(vals))
            with open(self._path) as f:
                lines = f.read().splitlines()
            old_keys = lines[0].split(",")[3:]
            with open(self._path, "w") as f:
                f.write("phase,step,epoch," + ",".join(self._keys) + "\n")
                for line in lines[1:]:
                    parts = line.split(",")
                    old = dict(zip(old_keys, parts[3:]))
                    f.write(",".join(parts[:3]) + ","
                            + ",".join(old.get(k, "") for k in self._keys) + "\n")
        with open(self._path, "a") as f:
            f.write(f"{phase},{step},{epoch},"
                    + ",".join("" if k not in vals else repr(vals[k]) for k in self._keys)
                    + "\n")


def fetch(metrics: dict) -> dict:
    """A dict of scalar tensors as Python floats, in one host transfer (one
    sync), each value as its fp32 value."""
    if not metrics:
        return {}
    values = torch.stack([v.detach().float().reshape(()) for v in metrics.values()])
    return dict(zip(metrics, values.tolist()))


def make_loaders(cfg: Config, device=None, mesh=None):
    """Dataset -> seeded 80/10/10 split (``overfit``: train = val = test) ->
    loaders ``(train, val, test)``. The procedural datasets generate on
    ``device`` (default ``cuda``), ``dataset_size`` samples; the file-backed
    ones read ``cfg.root`` on the host; an inpainting dataset also takes
    ``occlusion_ratio`` and ``static_occ``. ``device_cache`` keeps each split on
    ``device`` in ``device_cache_dtype``. Train batches shuffle per epoch
    and drop the ragged last batch; val and test keep it. Over a ``mesh`` of
    several ranks (default: the module docstring) each loader yields this
    rank's block of every global batch (``block=(rank, world)``)."""
    if mesh is None:
        mesh = parallel.default_mesh(cfg.mesh_shape, device)
    if cfg.dataset_name.startswith("Synthetic"):
        kwargs = {"device": device}
        if cfg.dataset_size:
            kwargs["size"] = cfg.dataset_size
    else:
        kwargs = {"root": cfg.root}
    if "Inpainting" in cfg.dataset_name:
        kwargs["occlusion_ratio"] = cfg.occlusion_ratio
        kwargs["static_occ"] = cfg.static_occ
    if cfg.image_size:
        kwargs["image_size"] = tuple(cfg.image_size)
    dataset = data_lib.build_dataset(cfg.dataset_name, **kwargs)
    if cfg.get("cache_data", False):
        dataset = data_lib.CacheDataset(dataset)
    if cfg.overfit:
        train_ds = val_ds = test_ds = dataset
    else:
        train_ds, val_ds, test_ds = data_lib.random_split(dataset, (0.8, 0.1, 0.1), seed=42)

    def mk(ds, shuffle):
        kw = dict(batch_size=cfg.batch_size, shuffle=shuffle, seed=cfg.seed,
                  num_workers=cfg.num_workers, drop_last=shuffle,
                  block=(mesh.rank, mesh.size) if mesh is not None and mesh.size > 1
                  else None)
        if cfg.get("device_cache", False):
            return data_lib.DeviceCacheLoader(
                ds, cache_dtype=cfg.get("device_cache_dtype", "bfloat16"),
                device=device, **kw)
        return data_lib.DataLoader(ds, **kw)

    return mk(train_ds, True), mk(val_ds, False), mk(test_ds, False)


def _data_mesh(cfg: Config, mesh, device, *steps):
    """The mesh of a run over several ranks (default: the module docstring),
    None for one; the steps must have been built for a mesh of its size."""
    if mesh is None:
        mesh = parallel.default_mesh(cfg.mesh_shape, device)
    if mesh is None or mesh.size == 1:
        return None
    for step in steps:
        built = getattr(step, "mesh", None)
        if built is None or built.size != mesh.size:
            raise NotImplementedError(
                f"{getattr(step, '__qualname__', step)} was not built for {mesh.size} ranks: "
                "build the step for the mesh (its hparams' _fast_mesh, or the default mesh)")
    return mesh


def _models(state) -> list:
    """The models of a ``TrainState`` or of a GAN run's ``(gen_state,
    dis_state)``."""
    return [s.model for s in (state if isinstance(state, tuple) else (state,))]


def fit(cfg: Config, state, train_step: Callable, eval_step: Callable, train_loader,
        val_loader, step_args: tuple = (), viz_fn: Optional[Callable] = None, mesh=None):
    """Run the epochs; returns the final state.

    Per train step: one host fetch of the metrics dict every
    ``log_every_n_steps`` steps (and no other sync), a ``FloatingPointError``
    on a non-finite loss, TensorBoard and CSV rows with ``images_per_sec``.
    Per epoch: the mean of each validation metric over the val batches,
    ``viz_fn(state, batch) -> {tag: uint8 [H, W, 3]}`` on the first val
    batch every ``log_image_every_epoch`` epochs (TensorBoard, and
    ``result_dir/val_{epoch}/{tag}.png``), the checkpoint of the epoch with
    its ``monitored_loss`` (val ``loss``), and early stopping after
    ``patience`` epochs without a better one. ``step_args``: extra
    positional arguments of the step functions. ``mesh``: several ranks
    (the module docstring).
    """
    device = state_device(state)
    mesh = _data_mesh(cfg, mesh, device, train_step, eval_step)
    if mesh is not None:
        parallel.replicated(_models(state), mesh)
    main = parallel.is_main_process()
    logger = SummaryLogger(cfg.log_dir, enabled=main)
    csv = CsvLogger(cfg.get("metrics_csv", "") if main else "")
    ckpt = CheckpointManager(cfg.checkpoint_dir)

    best = float("inf")
    bad_epochs = 0
    global_step = 0
    timer = StepTimer()
    try:
        for epoch in range(cfg.max_epochs):
            train_loader.set_epoch(epoch)
            for batch in data_lib.device_iterator(train_loader, device, mesh):
                state, metrics = train_step(state, *step_args, batch)
                timer.tick(cfg.batch_size)
                if global_step % cfg.log_every_n_steps == 0:
                    host = fetch(metrics)
                    loss_val = host.get("loss", next(iter(host.values())))
                    if not np.isfinite(loss_val):
                        raise FloatingPointError(
                            f"non-finite training loss {loss_val} at step "
                            f"{global_step} (epoch {epoch})")
                    for k, v in host.items():
                        logger.scalar(f"train_{k}", v, global_step)
                    logger.scalar("images_per_sec", timer.images_per_sec, global_step)
                    csv.row("train", global_step, epoch,
                            {**host, "images_per_sec": timer.images_per_sec})
                global_step += 1

            val_metrics = []
            first_val_batch = None
            for batch in data_lib.device_iterator(val_loader, device, mesh):
                if first_val_batch is None:
                    first_val_batch = batch
                val_metrics.append(fetch(eval_step(state, *step_args, batch)))

            if viz_fn is not None and first_val_batch is not None and main \
                    and epoch % cfg.log_image_every_epoch == 0:
                val_dir = os.path.join(cfg.result_dir, f"val_{epoch}")
                os.makedirs(val_dir, exist_ok=True)
                for tag, img in viz_fn(state, first_val_batch).items():
                    logger.image(f"val/{tag}", img, epoch)
                    write_png(os.path.join(val_dir, f"{tag}.png"), img)
            if not val_metrics:
                continue
            avg = {k: float(np.mean([m[k] for m in val_metrics])) for k in val_metrics[0]}
            # every rank must see the same val metric, or their early-stop
            # and best-checkpoint decisions part
            avg = parallel.global_mean_metrics(avg, mesh, device)
            for k, v in avg.items():
                logger.scalar(f"val_{k}", v, epoch)
            csv.row("val", global_step, epoch, avg)
            monitored = avg.get("loss", next(iter(avg.values())))
            logger.scalar("monitored_loss", monitored, epoch)
            logger.flush()

            if main:
                ckpt.save(epoch, state, monitored)
            if monitored < best - 1e-12:
                best = monitored
                bad_epochs = 0
            else:
                bad_epochs += 1
                if bad_epochs >= cfg.patience:
                    break
    finally:
        logger.close()
    if mesh is not None:
        parallel.check_replicated(_models(state), mesh)
    return state


def evaluate(cfg: Config, state, eval_step: Callable, loader, step_args: tuple = (),
             mesh=None) -> dict:
    """The mean of each metric of ``eval_step`` over a loader's batches
    (over several ranks: of the global batches, the same on every rank)."""
    device = state_device(state)
    mesh = _data_mesh(cfg, mesh, device, eval_step)
    out = [fetch(eval_step(state, *step_args, batch))
           for batch in data_lib.device_iterator(loader, device, mesh)]
    if not out:
        return {}
    return parallel.global_mean_metrics(
        {k: float(np.mean([m[k] for m in out])) for k in out[0]}, mesh, device)
