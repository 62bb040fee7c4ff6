"""Two-stage pipelines, flow -> occlusion -> inpainting (port of
``ocflow_tpu/train/steps_two_stage.py``).

- :func:`make_two_stage_step` (TwoStageModel): a frozen flow net, passed
  to the step as ``frozen = {'flow': net}`` (it never enters the
  optimizer), and a trainable occlusion net, the state's model.
- :func:`make_two_stage_gc_step` (TwoStageModelGC): the ground-truth flow
  warps frame 2; the state's model is ``nn.ModuleDict({'occ': ...,
  'inpaint': ...})`` (its ``state_dict`` the JAX ``params`` tree ``{'occ',
  'inpaint'}``), trained by :class:`GatedAdam` from
  :func:`make_two_stage_gc_optimizer`, whose inpainter group sees a zero
  gradient until ``unfreeze_step``.

Batches are dicts of NHWC tensors (``images`` [B, H, W, 6], the GC step's
``flow`` [B, H, W, 2], optional ``occ``). The steps run in fp32 with full
fp32 convolutions and matmuls (``full_fp32_convs``), as the JAX steps
compute. Over several ranks (``hparams['_fast_mesh']``,
``train.steps_inpainting``'s module docstring) each loss and metric is its
share of the global-batch value, every BatchNorm in train mode takes the
global batch's statistics, and the gradients are summed over the ranks
before the optimizer (``GatedAdam`` too: every rank takes the same gated
or unfrozen branch, and a parameter without a gradient has none on any).
"""

from __future__ import annotations

import torch
from torch import nn

from ocflow_torch import losses, parallel
from ocflow_torch.losses.perceptual import vgg_perceptual_loss
from ocflow_torch.ops import warp
from ocflow_torch.train.steps import _shares, _step_mesh
from ocflow_torch.train.steps_inpainting import _apply_generator, _build_steps, check_vgg


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def _warp_nhwc(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """``img`` [B, H, W, C] backward-warped by ``flow`` [B, H, W, 2]
    (``align_corners=True``), NHWC."""
    return warp(_nchw(img), _nchw(flow), align_corners=True).permute(0, 2, 3, 1)


def make_two_stage_step(hparams: dict):
    """TwoStageModel: ``train_step(state, frozen, batch)`` and
    ``eval_step(state, frozen, batch)`` with ``frozen = {'flow': flow net}``.

    The frozen flow net runs in eval mode without gradients; frame 2 is
    warped by its flow (``align_corners=True``); the occlusion net (the
    state's model, train mode in the train step) predicts ``occ``. The loss
    is ``photo + reconst_weight * reconst + smoothness_weight * smooth``
    with ``photo`` the photometric error of the warp against frame 1 off the
    occlusion, ``reconst`` the same on it (the warped frame, not a completed
    one, as the reference compares), ``smooth`` the first-order smoothness
    of the flow. The reference also completes the occluded warp with the
    frozen inpainter and uses nothing of it (dead code under ``jax.jit``);
    the port neither runs that forward nor takes an inpainter. Metrics ``loss``, ``photometric``, ``reconst``, ``smoothness``,
    and ``bce_loss`` when the batch has ``occ``."""
    smooth_w = hparams.get("smoothness_weight", 0.0)
    reconst_w = hparams.get("reconst_weight", 1.0)
    mesh = _step_mesh(hparams)
    mean, _ = _shares(mesh)

    def loss_fn(model, frozen, batch):
        imgs = batch["images"]
        img1, img2 = imgs[..., :3], imgs[..., 3:]
        flow_net = frozen["flow"].eval()
        # eval mode: running statistics, but FlowNetCV's feature moments
        # are the global batch's in either mode
        with torch.no_grad(), parallel.synced_stats(flow_net, mesh):
            flow = flow_net(imgs)
            flow = flow[0] if isinstance(flow, tuple) else flow
            img_warped = _warp_nhwc(img2, flow)
        occ = model(imgs)
        smooth = mean(losses.first_order_smoothness_loss(_nchw(img1), _nchw(flow)))
        photo = mean(losses.photometric_error(img_warped * (1.0 - occ), img1 * (1.0 - occ)))
        reconst = mean(losses.photometric_error(img_warped * occ, img1 * occ))
        loss = photo + reconst_w * reconst + smooth_w * smooth
        metrics = {"loss": loss, "photometric": photo, "reconst": reconst,
                   "smoothness": smooth}
        if "occ" in batch:
            metrics["bce_loss"] = mean(losses.binary_cross_entropy(occ, batch["occ"]))
        return loss, metrics

    return _build_steps(loss_fn, mesh)


class GatedAdam(torch.optim.Adam):
    """``torch.optim.Adam`` whose param groups may carry ``unfreeze_step``:
    before that many updates the group's gradient is scaled by 0 ahead of
    Adam, as optax's ``scale_by_schedule`` gates it. Every parameter gets
    a gradient tensor at every update (a zero one where it had none), so
    every Adam count advances each update, as optax's counts do: the
    first unfrozen update's bias correction is ``1 - beta^(unfreeze_step +
    1)``, and a gated parameter keeps its value bit for bit (its moments
    stay 0). The groups' update count ``updates`` rides in the state_dict."""

    def __init__(self, groups, **kwargs):
        super().__init__(groups, **kwargs)
        for g in self.param_groups:
            g.setdefault("unfreeze_step", 0)
            g.setdefault("updates", 0)

    @torch.no_grad()
    def step(self, closure=None):
        for g in self.param_groups:
            gated = g["updates"] < g["unfreeze_step"]
            for p in g["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                elif gated:
                    p.grad.mul_(0.0)
            g["updates"] += 1
        return super().step(closure)


def make_two_stage_gc_optimizer(model: nn.ModuleDict, lr: float, inpaint_lr: float = 1e-5,
                                unfreeze_step: int = 0) -> GatedAdam:
    """Adam at ``lr`` over ``model['occ']``; Adam at ``inpaint_lr`` over
    ``model['inpaint']``, its updates gated to 0 until ``unfreeze_step``
    (the reference's FinetuningInpainting unfreezes at epoch 23 at 1e-5)."""
    return GatedAdam([{"params": list(model["occ"].parameters()), "lr": lr},
                      {"params": list(model["inpaint"].parameters()), "lr": inpaint_lr,
                       "unfreeze_step": unfreeze_step}])


def make_two_stage_gc_step(hparams: dict, vgg=None):
    """TwoStageModelGC: ``train_step(state, batch)``, ``eval_step(state,
    batch)`` over ``state.model = nn.ModuleDict({'occ', 'inpaint'})``.

    Frame 2 is warped by the batch's ground-truth ``flow``
    (``align_corners=True``); the occlusion net gives ``occ`` (soft) and
    the inpainter completes the warp under it, both in train mode in the
    train step (the inpainter's BatchNorm statistics move in the gated
    phase too). The reference also hardens ``occ`` with the straight-through
    threshold and uses nothing of it (dead under ``jax.jit``): not run here.
    The loss is ``photo_weight * photo + reconst_weight * reconst +
    smooth1_weight * smooth + pixelwise_weight * pixelwise``: ``photo`` and
    ``photometric_occluded`` the photometric error of the warp against frame
    1 off and on the occlusion, ``reconst`` the completed frame against frame
    1 on it (photometric, or with ``loss_type: vgg`` the perceptual loss on
    ``vgg``), ``smooth`` the first-order smoothness of ``occ`` on the warp,
    ``pixelwise`` ``recon_loss`` of the completed frame under ``occ``.
    Metrics those terms, ``loss``, and ``bce_loss`` when the batch has
    ``occ``."""
    loss_type = hparams.get("loss_type", "pixel-wise")
    photo_w = hparams.get("photo_weight", 0.0)
    reconst_w = hparams.get("reconst_weight", 1.0)
    smooth1_w = hparams.get("smooth1_weight", 1.0)
    pixelwise_w = hparams.get("pixelwise_weight", 1.0)
    check_vgg(loss_type, vgg)
    mesh = _step_mesh(hparams)
    mean, _ = _shares(mesh)

    def loss_fn(model, batch):
        imgs = batch["images"]
        img1, img2 = imgs[..., :3], imgs[..., 3:]
        with torch.no_grad():
            img_warped = _warp_nhwc(img2, batch["flow"])
        occ = model["occ"](imgs)
        smooth = mean(losses.first_order_smoothness_loss(_nchw(img_warped), _nchw(occ)))
        completed = _apply_generator(model["inpaint"], img_warped, occ)[1]
        photo = mean(losses.photometric_error(img_warped * (1.0 - occ), img1 * (1.0 - occ)))
        photo_occ = mean(losses.photometric_error(img_warped * occ, img1 * occ))
        if loss_type == "vgg":
            reconst = mean(vgg_perceptual_loss(vgg, occ * completed, occ * img1))
        else:
            reconst = mean(losses.photometric_error(occ * completed, occ * img1))
        pixelwise = mean(losses.recon_loss(completed, img1, occ)[0])
        loss = (photo_w * photo + reconst_w * reconst + smooth1_w * smooth
                + pixelwise_w * pixelwise)
        metrics = {"loss": loss, "photometric": photo, "photometric_occluded": photo_occ,
                   "reconst": reconst, "smoothness": smooth, "pixelwise": pixelwise}
        if "occ" in batch:
            metrics["bce_loss"] = mean(losses.binary_cross_entropy(occ, batch["occ"]))
        return loss, metrics

    return _build_steps(loss_fn, mesh)
