"""Inpainting training steps (port of ``ocflow_tpu/train/steps_inpainting.py``):
the supervised step, the stage step with the pixel-wise loss and the
SN-PatchGAN step (discriminator, then generator).

Batches are dicts of NHWC tensors: the supervised step reads ``images``
[B, H, W, 6], ``flow`` [B, H, W, 2] and ``occ`` [B, H, W, 1]; the stage
step the inpainting datasets' ``image`` [B, H, W, 3] (complete) and ``occ``
(the synthetic mask, 1 = hole). ``train_step`` runs the generator in train
mode (BatchNorm on the batch's statistics, running ones updated, as the
JAX step's ``mutable=['batch_stats']``) and takes one Adam step;
``eval_step`` runs it in eval mode without gradients. Both run in fp32
with full fp32 cuDNN convolutions and matmuls (``full_fp32_convs``), as the
JAX steps compute. ``loss_type: vgg`` (a perceptual loss on a VGG16) is
ROADMAP A10.5.
"""

from __future__ import annotations

import contextlib

import torch

from ocflow_torch import full_fp32_convs, losses
from ocflow_torch.models.common import frozen_stats
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


@contextlib.contextmanager
def _no_param_grads(model: torch.nn.Module):
    """Inside, ``model``'s parameters record no gradient (each flag is given
    back on exit): autograd reaches through the model to its inputs only."""
    params = [p for p in model.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def make_gan_inpainting_step(hparams: dict):
    """SN-PatchGAN training, the discriminator first, then the generator
    against the updated discriminator, in the reference's order
    (``ocflow_tpu/train/steps_inpainting.py:make_gan_inpainting_step``).

    Returns ``train_step((gen_state, dis_state), batch) -> ((gen_state,
    dis_state), metrics)`` on the inpainting datasets' ``{'image', 'occ'}``:

    1. the generator in train mode without gradients, its BatchNorm
       updates thrown away (the JAX step never uses them), and
       ``complete = recon * occ + image * (1 - occ)``;
    2. the discriminator in train mode on ``cat([pos, neg])`` along the
       batch (``pos = [image, occ]``, ``neg = [complete, occ]``, channels
       last), its spectral norms' ``u`` and ``sigma`` updated once; the
       hinge loss ``sn_dis_loss`` on the two halves; one step of its
       optimizer;
    3. the generator in train mode (its BatchNorm statistics kept), held
       against the updated discriminator in eval mode (the power iteration
       runs from the new ``u``, nothing is stored, its parameters record
       no gradient); the loss ``sn_gen_loss + recon_loss``; one step of the
       generator's optimizer.

    Metrics: ``whole_loss``, ``d_loss``, ``g_loss``, ``content_loss``,
    ``occluded``, ``non_occluded``. fp32 with full fp32 convolutions and
    matmuls (``full_fp32_convs``). ``hparams['loss_type']``: ``pixel-wise``
    (the default); ``vgg`` raises (ROADMAP A10.5)."""
    check_loss_type(hparams.get("loss_type", "pixel-wise"))

    def train_step(state_pair, batch):
        gen_state, dis_state = state_pair
        gen, dis = gen_state.model, dis_state.model
        dev = gen_state.device
        imgs, masks = batch["image"].to(dev), batch["occ"].to(dev)
        gen.train()
        dis.train()
        with full_fp32_convs(torch.float32):
            with torch.no_grad(), frozen_stats(gen):
                _, recon = _apply_generator(gen, imgs, masks)
                complete = recon * masks + imgs * (1.0 - masks)
            pos = torch.cat([imgs, masks], -1)
            neg = torch.cat([complete, masks], -1)

            dis_state.optimizer.zero_grad(set_to_none=True)
            pred_pos, pred_neg = dis(torch.cat([pos, neg], 0)).chunk(2, 0)
            d_loss = losses.sn_dis_loss(pred_pos, pred_neg)
            d_loss.backward()
            dis_state.optimizer.step()
            dis_state.step += 1

            gen_state.optimizer.zero_grad(set_to_none=True)
            coarse, recon = _apply_generator(gen, imgs, masks)
            complete = recon * masks + imgs * (1.0 - masks)
            dis.eval()
            try:
                with _no_param_grads(dis):
                    g_loss = losses.sn_gen_loss(dis(torch.cat([complete, masks], -1)))
                    content, rhole, runhole = losses.recon_loss(imgs, recon, masks, coarse)
                    whole = g_loss + content
                    whole.backward()
            finally:
                dis.train()
            gen_state.optimizer.step()
            gen_state.step += 1
        metrics = {"whole_loss": whole, "d_loss": d_loss, "g_loss": g_loss,
                   "content_loss": content, "occluded": rhole, "non_occluded": runhole}
        return (gen_state, dis_state), {k: v.detach() for k, v in metrics.items()}

    return train_step
