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
JAX steps compute. ``loss_type: vgg`` adds (the stage step) or takes the
place of (the GAN step's content term) the VGG16 perceptual loss
(``losses.perceptual``) on the frozen VGG16 the factory is given.

Data parallelism (``hparams['_fast_mesh']``, by default the mesh over every
process when more than one runs; ``train.steps``' module docstring): each
rank takes its block of the global batch, every loss and metric is its
share of the global-batch value (a mean over the world size, a ratio loss
over the denominator summed over the ranks), the BatchNorms take the
global batch's statistics (``parallel.synced_stats`` around the forward and
the backward, remat's recompute included), the gradients are summed over
the ranks before the optimizer, the metrics all-reduced.
"""

from __future__ import annotations

import contextlib

import torch

from ocflow_torch import full_fp32_convs, losses, parallel
from ocflow_torch.losses.perceptual import vgg_perceptual_loss
from ocflow_torch.models.common import frozen_stats
from ocflow_torch.ops import warp
from ocflow_torch.train.steps import _shares, _step_mesh, _sync_grads, _sync_metrics


def _apply_generator(model, imgs: torch.Tensor, masks: torch.Tensor):
    """``(coarse or None, refined)`` of an inpainting generator on NHWC
    ``imgs`` and ``masks``, normalizing the ``(coarse, refined)`` and
    ``refined`` signatures."""
    out = model(imgs, masks)
    return out if isinstance(out, tuple) else (None, out)


def _build_steps(loss_fn, mesh=None):
    """``(train_step, eval_step)`` around ``loss_fn(model, *args, batch) ->
    (loss, metrics)``, the batch's tensors moved to the state's device;
    ``args`` are the steps' positional arguments between the state and the
    batch (``fit``'s ``step_args``). Over a ``mesh`` of several ranks
    ``loss_fn`` returns the global values' shares (the module docstring)."""

    def run(state, args):
        *args, batch = args
        batch = {k: v.to(state.device) for k, v in batch.items()}
        with full_fp32_convs(torch.float32):
            return loss_fn(state.model, *args, batch)

    def train_step(state, *args):
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        with parallel.synced_stats(state.model, mesh):
            loss, metrics = run(state, args)
            with full_fp32_convs(torch.float32):
                loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if mesh is not None:
            _sync_grads(state.model, mesh)
            metrics = _sync_metrics(metrics, mesh)
        state.optimizer.step()
        state.step += 1
        return state, metrics

    def eval_step(state, *args):
        state.model.eval()
        with torch.no_grad(), parallel.synced_stats(state.model, mesh):
            metrics = run(state, args)[1]
        return _sync_metrics(metrics, mesh) if mesh is not None else metrics

    train_step.mesh = eval_step.mesh = mesh
    return train_step, eval_step


def make_supervised_inpainting_step(hparams: dict | None = None):
    """Frame 2 warped to frame 1 by the ground-truth flow (``align_corners=
    False``), its ground-truth occluded region zeroed, completed by the
    generator under that mask; the loss is the masked L1 against frame 1
    over the hole (``losses.masked_l1_loss``). Metrics: ``loss``."""
    mesh = _step_mesh(hparams)
    _, red = _shares(mesh)

    def loss_fn(model, batch):
        imgs, occ = batch["images"], batch["occ"]
        img1 = imgs[..., :3]
        img2 = imgs[..., 3:].permute(0, 3, 1, 2)
        warped = warp(img2, batch["flow"].permute(0, 3, 1, 2), align_corners=False)
        warped = warped.permute(0, 2, 3, 1)
        _, completed = _apply_generator(model, warped * (1.0 - occ), occ)
        loss = losses.masked_l1_loss(completed, img1, occ, **red)
        return loss, {"loss": loss}

    return _build_steps(loss_fn, mesh)


def check_vgg(loss_type: str, vgg) -> None:
    """``loss_type: vgg`` needs the VGG16 (``losses.perceptual.init_vgg16``);
    any other loss type is the pixel-wise loss, as in the JAX steps."""
    if loss_type == "vgg" and vgg is None:
        raise ValueError("loss_type='vgg' requires vgg=init_vgg16(...)")


def make_inpainting_stage_step(hparams: dict, vgg=None):
    """Inpainting pre-training on synthetic occlusions: the generator
    completes the batch's ``image`` under its ``occ`` (it zeroes the hole
    itself); the loss is ``losses.recon_loss`` (the hole and un-hole L1,
    each over the image's mask share; a coarse output's terms too).
    ``hparams['loss_type']``: ``pixel-wise`` (the default; metrics
    ``loss``, ``rhole``, ``runhole``) or ``vgg``: the perceptual loss of the
    reconstruction against the frame on ``vgg`` plus ``reconst_weight``
    times ``recon_loss`` (metrics ``loss``, ``vgg_loss``,
    ``reconst_loss``)."""
    loss_type = hparams.get("loss_type", "pixel-wise")
    reconst_weight = hparams.get("reconst_weight", 1.0)
    check_vgg(loss_type, vgg)
    mesh = _step_mesh(hparams)
    mean, _ = _shares(mesh)

    def loss_fn(model, batch):
        imgs, masks = batch["image"], batch["occ"]
        coarse, recon = _apply_generator(model, imgs, masks)
        total, rhole, runhole = (mean(t) for t in losses.recon_loss(imgs, recon, masks, coarse))
        if loss_type == "vgg":
            vgg_loss = mean(vgg_perceptual_loss(vgg, recon, imgs))
            loss = vgg_loss + reconst_weight * total
            return loss, {"loss": loss, "vgg_loss": vgg_loss, "reconst_loss": total}
        return total, {"loss": total, "rhole": rhole, "runhole": runhole}

    return _build_steps(loss_fn, mesh)


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


def make_gan_inpainting_step(hparams: dict, vgg=None):
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
    (the default: the content term is ``recon_loss``) or ``vgg`` (the
    content term is the perceptual loss of the reconstruction on ``vgg``;
    ``occluded`` and ``non_occluded`` are ``recon_loss``'s terms all the
    same).

    Over a mesh (the module docstring) both generator forwards take the
    global batch's BatchNorm statistics, the discriminator's train forward
    on each rank's ``[pos block; neg block]`` too (together the global
    ``[pos; neg]``), its eval forward none; each optimizer steps on the
    gradients summed over the ranks. The spectral norms' ``u`` follow from
    the replicated weights alone, so they stay replicated bit for bit."""
    loss_type = hparams.get("loss_type", "pixel-wise")
    check_vgg(loss_type, vgg)
    mesh = _step_mesh(hparams)
    mean, _ = _shares(mesh)

    def train_step(state_pair, batch):
        gen_state, dis_state = state_pair
        gen, dis = gen_state.model, dis_state.model
        dev = gen_state.device
        imgs, masks = batch["image"].to(dev), batch["occ"].to(dev)
        gen.train()
        dis.train()
        with full_fp32_convs(torch.float32), parallel.synced_stats(gen, mesh), \
                parallel.synced_stats(dis, mesh):
            with torch.no_grad(), frozen_stats(gen):
                _, recon = _apply_generator(gen, imgs, masks)
                complete = recon * masks + imgs * (1.0 - masks)
            pos = torch.cat([imgs, masks], -1)
            neg = torch.cat([complete, masks], -1)

            dis_state.optimizer.zero_grad(set_to_none=True)
            pred_pos, pred_neg = dis(torch.cat([pos, neg], 0)).chunk(2, 0)
            d_loss = mean(losses.sn_dis_loss(pred_pos, pred_neg))
            d_loss.backward()
            if mesh is not None:
                _sync_grads(dis, mesh)
            dis_state.optimizer.step()
            dis_state.step += 1

            gen_state.optimizer.zero_grad(set_to_none=True)
            coarse, recon = _apply_generator(gen, imgs, masks)
            complete = recon * masks + imgs * (1.0 - masks)
            dis.eval()
            try:
                with _no_param_grads(dis):
                    g_loss = mean(losses.sn_gen_loss(dis(torch.cat([complete, masks], -1))))
                    content, rhole, runhole = (
                        mean(t) for t in losses.recon_loss(imgs, recon, masks, coarse))
                    if loss_type == "vgg":
                        content = mean(vgg_perceptual_loss(vgg, recon, imgs))
                    whole = g_loss + content
                    whole.backward()
            finally:
                dis.train()
            if mesh is not None:
                _sync_grads(gen, mesh)
            gen_state.optimizer.step()
            gen_state.step += 1
        metrics = {"whole_loss": whole, "d_loss": d_loss, "g_loss": g_loss,
                   "content_loss": content, "occluded": rhole, "non_occluded": runhole}
        metrics = {k: v.detach() for k, v in metrics.items()}
        if mesh is not None:
            metrics = _sync_metrics(metrics, mesh)
        return (gen_state, dis_state), metrics

    train_step.mesh = mesh
    return train_step
