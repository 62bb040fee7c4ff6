"""The occlusion-aware unsupervised flow step (port of
``ocflow_tpu/train/steps.py`` ``make_unsupervised_flow_step``).

Batches are dicts of NHWC tensors, as in the JAX package:
  ``images`` [B, H, W, 6]  (frames 1 | 2 on channels, in [-1, 1])
  ``flow``   [B, H, W, 2]  (optional ground truth, metric only)
  ``occ``    [B, H, W, 1]  (optional ground-truth occlusion, 1 = occluded)
Inside, the step computes NCHW. The state (``train.state.TrainState``) is
updated in place; ``train_step`` returns it with the metrics.

Mixed precision (``compute_dtype='bfloat16'``): the fused forward casts the
images, and the weights inside the graph, to bf16; Adam updates the fp32
master weights. Loss reductions accumulate in fp32 and warp and range-map
coordinates stay fp32. The loss tail works on bf16 images.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ocflow_torch import losses
from ocflow_torch.models.pwc_fast import fast_apply, fast_apply_pair
from ocflow_torch.ops import (occlusion_fb_consistency, occlusion_from_back_flow,
                              resize_bilinear, warp)


def _area_down(x: torch.Tensor, f: int) -> torch.Tensor:
    """f-x area (average-pool) downsample of an NCHW map."""
    return F.avg_pool2d(x, f)


def _nchw(t: torch.Tensor | None) -> torch.Tensor | None:
    return None if t is None else t.permute(0, 3, 1, 2)


def resolve_dtype(name) -> torch.dtype | None:
    """``'bfloat16'`` / ``'float32'`` / None / a dtype -> the compute dtype,
    None for fp32."""
    if name is None or name == "float32" or name == torch.float32:
        return None
    return getattr(torch, name) if isinstance(name, str) else name


def _apply_flow_net(model, x: torch.Tensor):
    """The eager network on ``[B, H, W, 6]``; returns ``(flow_full,
    flow_l2 or None)`` NHWC, normalizing the net's output signature."""
    out = model(x)
    return out if isinstance(out, tuple) else (out, None)


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

    def _photo(img_warped, img1, occ):
        if photo_loss == "census":
            return losses.census_loss(img_warped, img1, occ)
        return losses.photometric_error(img_warped, img1, occ)

    def loss_fn(state, batch):
        model, dev = state.model, state.device
        imgs = batch["images"].to(dev)
        img1, img2 = _nchw(imgs[..., :3]), _nchw(imgs[..., 3:])
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
            # the backward flow carries no gradient (the reference's no_grad)
            back_in = torch.cat([imgs[..., 3:], imgs[..., :3]], -1)
            with torch.no_grad():
                if back_pair is not None:
                    back_flow, back_l2 = back_pair
                elif fast_mode in ("both", "backward") and is_pwc:
                    bi = back_in.to(cdt) if cdt is not None else back_in
                    back_flow, back_l2 = fast_apply(model, bi, q8=q8b, device=dev)
                else:
                    back_flow, back_l2 = _apply_flow_net(model, back_in)
                back_flow, back_l2 = _nchw(back_flow), _nchw(back_l2)
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
            smooth1 = losses.first_order_smoothness_loss(img1_s, flow_l2)
            smooth2 = losses.second_order_smoothness_loss(img1_s, flow_l2)
        else:
            smooth1 = losses.first_order_smoothness_loss(img1c, flow_pred)
            smooth2 = losses.second_order_smoothness_loss(img1c, flow_pred)

        loss = photo_w * photo + s1_w * smooth1 + s2_w * smooth2
        metrics = {"loss": loss, "photometric": photo, "smooth1": smooth1,
                   "smooth2": smooth2}
        if "flow" in batch:
            gt = _nchw(batch["flow"].to(dev))
            metrics["flow_error"] = ((flow_pred - gt) ** 2).mean()
            metrics["epe"] = torch.sqrt(((flow_pred.float() - gt) ** 2).sum(1)).mean()
        if occ_aware:
            metrics["photometric_occ"] = losses.photometric_error(
                img_warped, img1p, 1.0 - occ_photo)
            if "occ" in batch:
                metrics["occ_error"] = losses.binary_cross_entropy(
                    occ_pred, _nchw(batch["occ"].to(dev)))
        mark("losses")
        return loss, metrics

    def train_step(state, batch):
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(state, batch)
        loss.backward()
        mark("backward")
        state.optimizer.step()
        mark("optimizer")
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    def eval_step(state, batch):
        with torch.no_grad():
            return loss_fn(state, batch)[1]

    return train_step, eval_step
