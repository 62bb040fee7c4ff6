"""Unsupervised trainer CLI of the port: the ``network_type: flow`` regime
of the repository's ``train_unsupervised.py``, occlusion-aware through the
config's hparams, for every flow net of the registry that the JAX package
can train; and its ``network_type: inpainting`` stage regime without the
GAN.

    python -m ocflow_torch.train_unsupervised --config configs/longrun_synthetic.yaml \\
        [--max_epochs N] [--device cuda|cpu]

Builds the loaders (``train.loop.make_loaders``), the net seeded from
``cfg.seed`` (:func:`build_net`: ``model: pwc`` is
``FlowNetCV(displacement=cfg.displacement)`` on the fused path; any other
flow key is ``registry.build("flow", cfg.model)`` with the constructor's
defaults, as the JAX CLI builds it, so ``cfg.displacement`` does not reach
it: ``flownetc`` correlates at d=10, ``flownet`` and ``pwcnet`` at d=4)
with Adam at ``cfg.learning_rate`` over fp32 master weights, the step of
``train.steps.make_unsupervised_flow_step``, then runs ``train.loop.fit``
(CSV, TensorBoard, validation panels, the best checkpoint) and
``train.loop.evaluate`` on the test split, printing ``test: {...}``. A
net with BatchNorm normalizes by the batch in both passes of the step (the
stop-gradient backward-flow pass too) and keeps both updates of its
running statistics, as the JAX step does. ``eflownet`` and
``eflownet2`` raise: the JAX steps pass no dropout rng, so the reference
cannot train them either (``train.steps.check_trainable``).

``network_type: inpainting`` with ``model: simple`` and ``adversarial_loss:
false`` trains ``InpaintingNet`` on the inpainting datasets' ``{'image',
'occ'}`` with ``train.steps_inpainting.make_inpainting_stage_step``
(``loss_type: pixel-wise``), the validation panel ``inpaint`` (the masked
input, the raw reconstruction, the frame, the composite) from the net in
eval mode. The gated-conv generators (``model: gated``, ``org: true``) and
``adversarial_loss: true`` are ROADMAP A10.3, ``loss_type: vgg`` A10.5, and
``network_type: twostage`` A10.4; each raises. Runs on ``cuda`` unless
``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import time

import torch

from ocflow_torch import resolve_device
from ocflow_torch.models import registry
from ocflow_torch.models.pwc_net import FlowNetCV
from ocflow_torch.ops import warp
from ocflow_torch.train import config as config_lib
from ocflow_torch.train import loop
from ocflow_torch.train.state import create_train_state
from ocflow_torch.train.steps import (_apply_flow_net, check_trainable,
                                     make_unsupervised_flow_step)
from ocflow_torch.train.steps_inpainting import (_apply_generator, check_loss_type,
                                                 make_inpainting_stage_step)
from ocflow_torch.utils import panels


def check_supported(cfg: config_lib.Config) -> None:
    """Refuse what the port cannot train, saying why or where it is
    queued."""
    if cfg.network_type == "twostage":
        raise NotImplementedError(
            "network_type 'twostage': the two-stage pipelines are ROADMAP A10.4")
    if cfg.network_type == "inpainting":
        if cfg.adversarial_loss:
            raise NotImplementedError(
                "adversarial_loss: the SN-PatchGAN inpainting regime is ROADMAP A10.3")
        registry.check_ported("inpainting", "gated_org" if cfg.org else cfg.model)
        check_loss_type(cfg.loss_type)
        return
    if cfg.network_type != "flow":
        raise ValueError(f"network_type {cfg.network_type!r}: want 'flow', 'inpainting' "
                         "or 'twostage'")
    check_trainable(cfg.model)


def build_net(cfg: config_lib.Config) -> torch.nn.Module:
    """The config's flow net (or inpainting generator), seeded from
    ``cfg.seed``."""
    gen = torch.Generator().manual_seed(cfg.seed)
    if cfg.network_type == "inpainting":
        return registry.build("inpainting", cfg.model, generator=gen)
    if cfg.model == "pwc":
        return FlowNetCV(displacement=cfg.displacement, generator=gen)
    return registry.build("flow", cfg.model, generator=gen)


def viz_fn(state, batch) -> dict:
    """Validation panels of the first pair of a batch from the eager
    network (not the fused path) in eval mode without gradients, as the JAX
    panels apply the net with ``train=False`` (a BatchNorm net's running
    statistics stay as they are; the model's mode is given back): ``warp``
    (frames, frame 2 warped by the predicted flow, its colours) and, where
    the batch has ground truth, ``flow`` (frames, predicted and true flow's
    colours)."""
    imgs = batch["images"][:1].float()
    training = state.model.training
    state.model.eval()
    try:
        with torch.no_grad():
            flow = _apply_flow_net(state.model, imgs)[0]
            warped = warp(imgs[..., 3:].permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2))
    finally:
        state.model.train(training)
    img1 = imgs[0, ..., :3].cpu().numpy()
    img2 = imgs[0, ..., 3:].cpu().numpy()
    flow0 = flow[0].float().cpu().numpy()
    out = {"warp": panels.warp_panel(img1, img2,
                                     warped[0].permute(1, 2, 0).cpu().numpy(), flow0)}
    if "flow" in batch:
        out["flow"] = panels.flow_panel(img1, img2, flow0,
                                        batch["flow"][0].float().cpu().numpy())
    return out


def inpaint_viz_fn(state, batch) -> dict:
    """The validation panel ``inpaint`` of the first sample of a batch:
    the masked input, the generator's raw reconstruction (eval mode, no
    gradients; the model's mode is given back), the frame and the
    composite ``recon * occ + image * (1 - occ)``."""
    occluded, occ = batch["occluded"][:1].float(), batch["occ"][:1].float()
    training = state.model.training
    state.model.eval()
    try:
        with torch.no_grad():
            refined = _apply_generator(state.model, occluded, occ)[1][0].float().cpu().numpy()
    finally:
        state.model.train(training)
    image = batch["image"][0].float().cpu().numpy()
    occ0 = occ[0].cpu().numpy()
    complete = refined * occ0 + image * (1.0 - occ0)
    return {"inpaint": panels.inpainting_panel(occluded[0].cpu().numpy(), refined, image,
                                               complete)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Unsupervised trainer (PyTorch port)")
    ap.add_argument("--config", default="configs/longrun_synthetic.yaml")
    ap.add_argument("--max_epochs", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = config_lib.load_config(args.config)
    if args.max_epochs is not None:
        cfg.max_epochs = args.max_epochs
    check_supported(cfg)
    device = resolve_device(args.device)

    t0 = time.perf_counter()
    train_loader, val_loader, test_loader = loop.make_loaders(cfg, device)
    state = create_train_state(build_net(cfg), cfg.learning_rate, device=device)
    if cfg.network_type == "inpainting":
        train_step, eval_step = make_inpainting_stage_step(cfg.as_hparams())
        show = inpaint_viz_fn
    else:
        train_step, eval_step = make_unsupervised_flow_step(cfg.as_hparams())
        show = viz_fn
    state = loop.fit(cfg, state, train_step, eval_step, train_loader, val_loader,
                     viz_fn=show)
    fit_s = time.perf_counter() - t0
    results = loop.evaluate(cfg, state, eval_step, test_loader)
    print(f"fit: {state.step} steps of {cfg.batch_size} pairs in {fit_s:.1f} s wall on "
          f"{device} ({state.step * cfg.batch_size / fit_s:.2f} pairs/s, the data's "
          f"generation, validation, panels and checkpoints included)")
    print("test:", results)
    return results


if __name__ == "__main__":
    main()
