"""Inpainting training steps (port of ``ocflow_tpu/train/steps_inpainting.py``):
the supervised step and the stage step with the pixel-wise loss.

Batches are dicts of NHWC tensors: the supervised step reads ``images``
[B, H, W, 6], ``flow`` [B, H, W, 2] and ``occ`` [B, H, W, 1]; the stage
step the inpainting datasets' ``image`` [B, H, W, 3] (complete) and ``occ``
(the synthetic mask, 1 = hole). ``train_step`` runs the generator in train
mode (BatchNorm on the batch's statistics, running ones updated, as the
JAX step's ``mutable=['batch_stats']``) and takes one Adam step;
``eval_step`` runs it in eval mode without gradients. Both run in fp32
with full fp32 cuDNN convolutions and matmuls (``full_fp32_convs``), as the
JAX steps compute. The stage step's ``loss_type: vgg`` (a perceptual loss
on a VGG16) and the adversarial regime are ROADMAP A10.5 and A10.3.
"""

from __future__ import annotations

import torch

from ocflow_torch import full_fp32_convs, losses
from ocflow_torch.ops import warp


def _apply_generator(model, imgs: torch.Tensor, masks: torch.Tensor):
    """``(coarse or None, refined)`` of an inpainting generator on NHWC
    ``imgs`` and ``masks``, normalizing the ``(coarse, refined)`` and
    ``refined`` signatures."""
    out = model(imgs, masks)
    return out if isinstance(out, tuple) else (None, out)


def _build_steps(loss_fn):
    """``(train_step, eval_step)`` around ``loss_fn(model, batch) -> (loss,
    metrics)``, the batch's tensors moved to the state's device."""

    def run(state, batch):
        dev = state.device
        batch = {k: v.to(dev) for k, v in batch.items()}
        with full_fp32_convs(torch.float32):
            return loss_fn(state.model, batch)

    def train_step(state, batch):
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = run(state, batch)
        with full_fp32_convs(torch.float32):
            loss.backward()
        state.optimizer.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    def eval_step(state, batch):
        state.model.eval()
        with torch.no_grad():
            return run(state, batch)[1]

    return train_step, eval_step


def make_supervised_inpainting_step(hparams: dict | None = None):
    """Frame 2 warped to frame 1 by the ground-truth flow (``align_corners=
    False``), its ground-truth occluded region zeroed, completed by the
    generator under that mask; the loss is the masked L1 against frame 1
    over the hole (``losses.masked_l1_loss``). Metrics: ``loss``."""

    def loss_fn(model, batch):
        imgs, occ = batch["images"], batch["occ"]
        img1 = imgs[..., :3]
        img2 = imgs[..., 3:].permute(0, 3, 1, 2)
        warped = warp(img2, batch["flow"].permute(0, 3, 1, 2), align_corners=False)
        warped = warped.permute(0, 2, 3, 1)
        _, completed = _apply_generator(model, warped * (1.0 - occ), occ)
        loss = losses.masked_l1_loss(completed, img1, occ)
        return loss, {"loss": loss}

    return _build_steps(loss_fn)


def check_loss_type(loss_type: str) -> None:
    """Refuse a stage loss the port does not have: ``vgg`` needs the VGG16
    perceptual loss, ROADMAP A10.5."""
    if loss_type != "pixel-wise":
        raise NotImplementedError(
            f"loss_type {loss_type!r}: the VGG perceptual loss is ROADMAP A10.5; the port "
            "trains the stage step with loss_type 'pixel-wise'")


def make_inpainting_stage_step(hparams: dict):
    """Inpainting pre-training on synthetic occlusions: the generator
    completes the batch's ``image`` under its ``occ`` (it zeroes the hole
    itself); the loss is ``losses.recon_loss`` (the hole and un-hole L1,
    each over the image's mask share; a coarse output's terms too).
    ``hparams['loss_type']``: ``pixel-wise`` (the default); ``vgg`` raises.
    Metrics: ``loss``, ``rhole``, ``runhole``."""
    check_loss_type(hparams.get("loss_type", "pixel-wise"))

    def loss_fn(model, batch):
        imgs, masks = batch["image"], batch["occ"]
        coarse, recon = _apply_generator(model, imgs, masks)
        total, rhole, runhole = losses.recon_loss(imgs, recon, masks, coarse)
        return total, {"loss": total, "rhole": rhole, "runhole": runhole}

    return _build_steps(loss_fn)
