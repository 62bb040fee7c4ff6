"""The training steps (port of ``ocflow_tpu/train/steps.py``): the
supervised flow, occlusion and flow+occlusion steps and the
occlusion-aware unsupervised flow step.

Batches are dicts of NHWC tensors, as in the JAX package:
  ``images`` [B, H, W, 6]  (frames 1 | 2 on channels, in [-1, 1])
  ``flow``   [B, H, W, 2]  (optional ground truth, metric only)
  ``occ``    [B, H, W, 1]  (optional ground-truth occlusion, 1 = occluded)
Inside, the step computes NCHW. The state (``train.state.TrainState``) is
updated in place; ``train_step`` returns it with the metrics.

BatchNorm (the ``_apply_flow_net`` contract of the JAX package):
``train_step`` puts the model in train mode, so BatchNorm normalizes by the
batch's statistics and updates the running ones (flax's update,
``models.common.BatchNorm``); ``eval_step`` puts it in eval mode (the
running statistics, no update), as the JAX eval step runs ``train=False``.
The unsupervised step's no-gradient backward-flow pass runs in train mode
too and keeps its update, as the JAX step does.

Mixed precision (``compute_dtype='bfloat16'``): the fused forward casts the
images, and the weights inside the graph, to bf16; Adam updates the fp32
master weights. Loss reductions accumulate in fp32 and warp and range-map
coordinates stay fp32. The loss tail works on bf16 images. In the
unsupervised step every net but FlowNetCV (``model: pwc``) runs in fp32
with full fp32 cuDNN convolutions (no TF32) whatever ``compute_dtype``
says, as the JAX step runs them: there ``compute_dtype`` only casts the
loss tail's images.

Data parallelism (``hparams['_fast_mesh']``, by default the mesh over every
process when more than one runs, ``parallel.Mesh(0, 1)`` for a step of
this process alone; ``parallel.mesh``): the batch a step takes
is this rank's block of the global batch (``shard_batch``,
``data.device_iterator(..., mesh=)``), the forward runs on the block, and
every loss and metric is its global-batch value, as the JAX step computes
them on global arrays. A mean is the block's mean over the world size; a
ratio loss (photometric, census) the block's numerator over the denominator
summed over the ranks, without gradient, its epsilon added once. These
shares sum over the ranks to the global values: the metrics are
all-reduced, the parameter gradients summed between ``backward`` and the
optimizer step, so the replicas stay equal bit for bit. The batch
statistics are the global batch's too (``parallel.synced_stats`` around
the forward and the backward, train and eval steps): every train-mode
BatchNorm, in each pass, and the eager FlowNetCV's feature moments, in
either mode. The fused FlowNetCV (``fast_apply``) normalizes per block, as
the JAX package's ``shard_map`` forward does. ``hparams['_blocks'] = k``
runs the fused forward on ``k`` blocks of the batch in one process and the
losses on the whole: the single-process oracle of a step over ``k`` ranks
(an eager net's step over ``k`` ranks equals its step on the whole batch).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ocflow_torch import full_fp32_convs, losses, parallel
from ocflow_torch.models.precision import resolve_dtype
from ocflow_torch.models.pwc_fast import fast_apply, fast_apply_pair
from ocflow_torch.ops import (occlusion_fb_consistency, occlusion_from_back_flow,
                              resize_bilinear, warp)


def _area_down(x: torch.Tensor, f: int) -> torch.Tensor:
    """f-x area (average-pool) downsample of an NCHW map."""
    return F.avg_pool2d(x, f)


def _nchw(t: torch.Tensor | None) -> torch.Tensor | None:
    return None if t is None else t.permute(0, 3, 1, 2)


def _step_mesh(hparams: dict | None):
    """The mesh a step splits its batch over (the module docstring), None
    for one rank."""
    mesh = (hparams or {}).get("_fast_mesh") or parallel.default_mesh()
    return mesh if mesh is not None and mesh.size > 1 else None


def _shares(mesh):
    """``(mean, reduce)`` of a step over ``mesh`` (the module docstring):
    ``mean(t)`` turns a block's mean into its share of the global mean,
    ``reduce`` the ratio losses' keyword arguments (the denominator summed
    over the ranks); the identity and ``{}`` for one rank."""
    if mesh is None:
        return (lambda t: t), {}
    return (lambda t: t / mesh.size), {"reduce": mesh.sum}


def _sync_grads(model, mesh) -> None:
    """Sum the parameter gradients over the ranks, in one collective (a
    parameter without a gradient has none on every rank: the same graph)."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def _sync_metrics(metrics: dict, mesh) -> dict:
    """Each rank's shares summed over the ranks, in one collective, in their
    widest dtype (fp32 at least): the global values."""
    dtype = torch.float32
    for v in metrics.values():
        dtype = torch.promote_types(dtype, v.dtype)
    vec = mesh.all_reduce(torch.stack([v.detach().to(dtype).reshape(())
                                       for v in metrics.values()]))
    return dict(zip(metrics, vec.unbind()))


# flow keys the JAX package cannot train: EFlowNet's bottlenecks apply
# dropout in train mode, and the JAX steps pass no dropout rng
UNTRAINABLE = ("eflownet", "eflownet2")


def check_trainable(model: str) -> None:
    """Refuse to train a net that the JAX package cannot train either."""
    if model in UNTRAINABLE:
        raise NotImplementedError(
            f"model {model!r}: its bottlenecks apply dropout in train mode, and the JAX "
            "package's training steps pass no dropout rng (flax raises InvalidRngError), "
            "so the reference cannot train this net either; the port serves it "
            "(evaluate, infer) and does not train it")


def _apply_flow_net(model, x: torch.Tensor):
    """The eager network on ``[B, H, W, 6]``; returns ``(flow_full,
    flow_l2 or None)`` NHWC, normalizing the net's output signature."""
    out = model(x)
    return out if isinstance(out, tuple) else (out, None)


def _build_steps(loss_fn, compute_dtype: torch.dtype | None = None, mesh=None):
    """``(train_step, eval_step)`` around ``loss_fn(state, images, batch) ->
    (loss, metrics)``: one Adam step in train mode, or the metrics in eval
    mode without gradients. The fp32 cuDNN convolutions run without TF32;
    with ``compute_dtype`` the forward runs under autocast to it (bf16
    compute over the fp32 parameters, what flax's ``dtype=`` means). Every
    loss and metric is a mean over the batch: over a ``mesh`` of several
    ranks each is the block's mean over the world size, summed over the
    ranks (the module docstring)."""

    def run(state, batch):
        dev = state.device
        images = batch["images"].to(dev)
        with full_fp32_convs(torch.float32):
            if compute_dtype is None:
                loss, metrics = loss_fn(state, images, batch)
            else:
                with torch.autocast(dev.type, dtype=compute_dtype):
                    loss, metrics = loss_fn(state, images, batch)
        if mesh is not None:
            loss = loss / mesh.size
            metrics = {k: v / mesh.size for k, v in metrics.items()}
        return loss, metrics

    def train_step(state, batch):
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        with parallel.synced_stats(state.model, mesh):
            loss, metrics = run(state, batch)
            with full_fp32_convs(torch.float32):
                loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if mesh is not None:
            _sync_grads(state.model, mesh)
            metrics = _sync_metrics(metrics, mesh)
        state.optimizer.step()
        state.step += 1
        return state, metrics

    def eval_step(state, batch):
        state.model.eval()
        with torch.no_grad(), parallel.synced_stats(state.model, mesh):
            metrics = run(state, batch)[1]
        return _sync_metrics(metrics, mesh) if mesh is not None else metrics

    train_step.mesh = eval_step.mesh = mesh
    return train_step, eval_step


def _gt(batch, key: str, like: torch.Tensor) -> torch.Tensor:
    return batch[key].to(device=like.device, dtype=torch.float32)


def _supervised_dtype(hparams: dict | None) -> torch.dtype | None:
    """The compute dtype of a supervised step: the config's
    ``compute_dtype`` for FlowNetCV (``model: pwc``, which the JAX CLI
    builds with ``dtype=``), fp32 for every other net."""
    hparams = hparams or {}
    if hparams.get("model") != "pwc":
        return None
    return resolve_dtype(hparams.get("compute_dtype"))


def make_supervised_flow_step(hparams: dict | None = None):
    """MSE of the full-resolution flow against the batch's ``flow``.
    Metrics: ``loss``."""

    def loss_fn(state, images, batch):
        flow = _apply_flow_net(state.model, images)[0].float()
        loss = ((flow - _gt(batch, "flow", flow)) ** 2).mean()
        return loss, {"loss": loss}

    return _build_steps(loss_fn, _supervised_dtype(hparams), _step_mesh(hparams))


def make_supervised_occ_step(hparams: dict | None = None):
    """Focal BCE (gamma 2) of the occlusion against the batch's ``occ``.
    Metrics: ``loss``."""

    def loss_fn(state, images, batch):
        occ = _apply_flow_net(state.model, images)[0].float()
        loss = losses.focal_bce_loss(occ, _gt(batch, "occ", occ))
        return loss, {"loss": loss}

    return _build_steps(loss_fn, _supervised_dtype(hparams), _step_mesh(hparams))


def make_supervised_flow_occ_step(hparams: dict | None = None):
    """L1 of the flow plus BCE of the occlusion, against the batch's
    ``flow`` and ``occ``. Metrics: ``loss``, ``flow_loss``, ``occ_loss``."""

    def loss_fn(state, images, batch):
        flow, occ = (t.float() for t in state.model(images))
        flow_loss = (flow - _gt(batch, "flow", flow)).abs().mean()
        occ_loss = losses.binary_cross_entropy(occ, _gt(batch, "occ", occ))
        loss = flow_loss + occ_loss
        return loss, {"loss": loss, "flow_loss": flow_loss, "occ_loss": occ_loss}

    return _build_steps(loss_fn, _supervised_dtype(hparams), _step_mesh(hparams))


def make_unsupervised_flow_step(hparams: dict):
    """Photometric + smoothness unsupervised flow training, optionally
    occlusion-aware. Returns ``(train_step, eval_step)``:
    ``train_step(state, batch) -> (state, metrics)`` (one Adam step) and
    ``eval_step(state, batch) -> metrics`` (no gradients).

    hparams (JAX package defaults): ``photo_weight`` 1.0,
    ``smooth1_weight`` 0.0, ``smooth2_weight`` 1.0, ``with_occ`` (mask with
    the batch's ``occ``), ``occ_aware`` (occlusion from the backward flow),
    ``occ_method`` ``range_map`` | ``fb_consistency``, ``occ_warmup_steps``
    (no mask while ``state.step`` is below it), ``occ_resolution`` ``full``
    | ``half`` | ``quarter``, ``model`` (``pwc``: smoothness at 1/4
    resolution on the level-2 flow, and the fused path), ``fast_forward``
    ``both`` (gradient pass through ``fast_apply_pair`` /
    ``fast_apply(diff=True)``) | ``backward`` (only the no-grad backward
    flow fused) | ``off`` (the eager network, fp32), ``photo_loss``
    ``charbonnier`` | ``census``, ``photo_resolution`` ``full`` | ``half`` |
    ``quarter``, ``compute_dtype``, ``q8_backward`` (W8A8 scales for the
    backward-flow decode), ``_mark`` (a timing hook: called with the name of
    each part of the step as it has been issued: ``encoder``, ``forward
    decode``, ``backward decode`` (the fused pair; ``forward`` on the other
    paths), ``occlusion``, ``losses``, ``backward``, ``optimizer``).

    Metrics: ``loss``, ``photometric``, ``smooth1``, ``smooth2``;
    ``flow_error`` and ``epe`` when the batch has ``flow``;
    ``photometric_occ`` and (with ``occ`` in the batch) ``occ_error`` under
    ``occ_aware``.
    """
    photo_w = hparams.get("photo_weight", 1.0)
    s1_w = hparams.get("smooth1_weight", 0.0)
    s2_w = hparams.get("smooth2_weight", 1.0)
    with_occ = hparams.get("with_occ", False)
    occ_aware = hparams.get("occ_aware", False)
    occ_method = hparams.get("occ_method", "range_map")
    occ_warmup = hparams.get("occ_warmup_steps", 0)
    occ_res = hparams.get("occ_resolution", "full")
    is_pwc = hparams.get("model", "simple") == "pwc"
    fast_mode = hparams.get("fast_forward", "both")
    photo_loss = hparams.get("photo_loss", "charbonnier")
    photo_res = hparams.get("photo_resolution", "full")
    cdt = resolve_dtype(hparams.get("compute_dtype"))
    q8b = hparams.get("q8_backward")
    mark = hparams.get("_mark") or (lambda name: None)
    mesh = _step_mesh(hparams)
    blocks = hparams.get("_blocks", 1)
    if mesh is not None and blocks != 1:
        raise ValueError("_blocks is the single-process oracle of a sharded step; "
                         "it takes no mesh")
    if blocks != 1 and not (is_pwc and fast_mode == "both"):
        raise ValueError("_blocks is the oracle of the fused forward (fast_forward: both); "
                         "an eager net over several ranks equals its step on the whole batch")
    # global-batch values from this rank's block (the module docstring)
    mean, red = _shares(mesh)

    def _photo(img_warped, img1, occ):
        if photo_loss == "census":
            return losses.census_loss(img_warped, img1, occ, **red)
        return losses.photometric_error(img_warped, img1, occ, **red)

    def forward(model, imgs, dev):
        """``(forward flow pair, backward flow pair or None)`` NHWC: the
        gradient-carrying forward and, under ``occ_aware``, the backward
        flow without gradient (the reference's no_grad)."""
        xi = imgs.to(cdt) if cdt is not None else imgs
        out = back_pair = None
        if fast_mode == "both" and is_pwc:
            if occ_aware:
                out, back_pair = fast_apply_pair(model, xi, q8=q8b, device=dev,
                                                 mark=mark)
            else:
                out = fast_apply(model, xi, device=dev, diff=True)
        if out is None:
            out = _apply_flow_net(model, imgs)
        if back_pair is None:
            mark("forward")
        if occ_aware and back_pair is None:
            back_in = torch.cat([imgs[..., 3:], imgs[..., :3]], -1)
            with torch.no_grad():
                if fast_mode in ("both", "backward") and is_pwc:
                    bi = back_in.to(cdt) if cdt is not None else back_in
                    back_pair = fast_apply(model, bi, q8=q8b, device=dev)
                else:
                    back_pair = _apply_flow_net(model, back_in)
        return out, back_pair

    def forward_blocks(model, imgs, dev):
        if blocks == 1:
            return forward(model, imgs, dev)
        parts = [forward(model, x, dev) for x in imgs.chunk(blocks)]

        def cat(pairs):
            return tuple(None if t[0] is None else torch.cat(t) for t in zip(*pairs))

        return cat([p[0] for p in parts]), (cat([p[1] for p in parts])
                                            if occ_aware else None)

    def loss_fn(state, batch):
        model, dev = state.model, state.device
        imgs = batch["images"].to(dev)
        img1, img2 = _nchw(imgs[..., :3]), _nchw(imgs[..., 3:])
        out, back_pair = forward_blocks(model, imgs, dev)
        flow_pred, flow_l2 = (_nchw(f) for f in out)

        img1c = img1.to(cdt) if cdt is not None else img1
        img2c = img2.to(cdt) if cdt is not None else img2
        if photo_res != "full":
            pf = 2 if photo_res == "half" else 4
            ph, pw = img1.shape[2] // pf, img1.shape[3] // pf
            img1p, img2p = _area_down(img1c, pf), _area_down(img2c, pf)
            flow_p = resize_bilinear(flow_pred, ph, pw, align_corners=True) * (1.0 / pf)
        else:
            pf = 1
            img1p, img2p, flow_p = img1c, img2c, flow_pred
        img_warped = warp(img2p, flow_p, align_corners=True)

        occ_pred = occ_photo = None
        if occ_aware:
            with torch.no_grad():
                back_flow, back_l2 = (_nchw(f) for f in back_pair)
                quarter = (occ_res == "quarter" and is_pwc
                           and flow_l2 is not None and back_l2 is not None)
                half = occ_res == "half" and not quarter
                if quarter:
                    fwd_o, bwd_o = flow_l2.detach(), back_l2.to(flow_l2.dtype)
                elif half:
                    fwd_o = _area_down(flow_pred.detach(), 2) * 0.5
                    bwd_o = _area_down(back_flow.to(fwd_o.dtype), 2) * 0.5
                else:
                    fwd_o, bwd_o = flow_pred.detach(), back_flow.to(flow_pred.dtype)
                if occ_method == "fb_consistency":
                    occ_pred = occlusion_fb_consistency(fwd_o, bwd_o)
                else:
                    occ_pred = occlusion_from_back_flow(bwd_o)
                up = 4 if quarter else 2 if half else 1
                if up > 1:
                    occ_pred = occ_pred.repeat_interleave(up, 2).repeat_interleave(up, 3)
                if occ_warmup and state.step < occ_warmup:
                    occ_pred = torch.zeros_like(occ_pred)
                occ_photo = occ_pred if pf == 1 else _area_down(occ_pred, pf)
            mark("occlusion")
            photo = _photo(img_warped, img1p, occ_photo)
        elif with_occ:
            occ_gt = _nchw(batch["occ"].to(dev))
            photo = _photo(img_warped, img1p, occ_gt if pf == 1 else _area_down(occ_gt, pf))
        else:
            photo = _photo(img_warped, img1p, None)

        if is_pwc and flow_l2 is not None:
            h, w = img1.shape[2] // 4, img1.shape[3] // 4
            img1_s = resize_bilinear(img1c, h, w, align_corners=True)
            smooth1 = mean(losses.first_order_smoothness_loss(img1_s, flow_l2))
            smooth2 = mean(losses.second_order_smoothness_loss(img1_s, flow_l2))
        else:
            smooth1 = mean(losses.first_order_smoothness_loss(img1c, flow_pred))
            smooth2 = mean(losses.second_order_smoothness_loss(img1c, flow_pred))

        loss = photo_w * photo + s1_w * smooth1 + s2_w * smooth2
        metrics = {"loss": loss, "photometric": photo, "smooth1": smooth1,
                   "smooth2": smooth2}
        if "flow" in batch:
            gt = _nchw(batch["flow"].to(dev))
            metrics["flow_error"] = mean(((flow_pred - gt) ** 2).mean())
            metrics["epe"] = mean(torch.sqrt(((flow_pred.float() - gt) ** 2).sum(1)).mean())
        if occ_aware:
            metrics["photometric_occ"] = losses.photometric_error(
                img_warped, img1p, 1.0 - occ_photo, **red)
            if "occ" in batch:
                metrics["occ_error"] = mean(losses.binary_cross_entropy(
                    occ_pred, _nchw(batch["occ"].to(dev))))
        mark("losses")
        return loss, metrics

    # the step's cuDNN convolutions, forward and backward, without TF32 in
    # fp32: the fused FlowNetCV computes in ``cdt``, every other net in fp32
    step_dtype = (cdt or torch.float32) if is_pwc else torch.float32

    def train_step(state, batch):
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        with full_fp32_convs(step_dtype), parallel.synced_stats(state.model, mesh):
            loss, metrics = loss_fn(state, batch)
            loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if mesh is not None:
            _sync_grads(state.model, mesh)
            metrics = _sync_metrics(metrics, mesh)
        mark("backward")
        state.optimizer.step()
        mark("optimizer")
        state.step += 1
        return state, metrics

    def eval_step(state, batch):
        state.model.eval()
        with torch.no_grad(), full_fp32_convs(step_dtype), \
                parallel.synced_stats(state.model, mesh):
            metrics = loss_fn(state, batch)[1]
        return _sync_metrics(metrics, mesh) if mesh is not None else metrics

    train_step.mesh = eval_step.mesh = mesh
    return train_step, eval_step
