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

``network_type: inpainting`` trains the generator ``model`` (``simple``,
``gated``; ``org: true`` is ``gated_org``; ``remat: true`` recomputes each
gated block in the backward pass) on the inpainting datasets' ``{'image',
'occ'}``: with ``adversarial_loss: false`` on
``train.steps_inpainting.make_inpainting_stage_step`` (``loss_type:
pixel-wise``); with ``adversarial_loss: true`` on
``make_gan_inpainting_step`` against the spectral-norm discriminator of the
same kind (seeded from 1, Adam at 4x the learning rate), the state the pair
``(gen_state, dis_state)`` (its checkpoints too), validated by the
pixel-wise stage step on the generator, which is saved alone after the run
to ``checkpoint_dir/generator`` (``{"params": state_dict}``, what
``evaluate --checkpoint`` loads). The validation panel ``inpaint`` (the
masked input, the raw reconstruction, the frame, the composite) comes from
the generator in eval mode. ``loss_type: vgg`` (ROADMAP A10.5) and
``network_type: twostage`` (A10.4) raise. Runs on ``cuda`` unless
``--device`` says otherwise; on the card the run ends by printing its peak
memory.
"""

from __future__ import annotations

import argparse
import os
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
                                                 make_gan_inpainting_step,
                                                 make_inpainting_stage_step)
from ocflow_torch.utils import panels
from ocflow_torch.utils.checkpoint import save_pytree


def check_supported(cfg: config_lib.Config) -> None:
    """Refuse what the port cannot train, saying why or where it is
    queued."""
    if cfg.network_type == "twostage":
        raise NotImplementedError(
            "network_type 'twostage': the two-stage pipelines are ROADMAP A10.4")
    if cfg.network_type == "inpainting":
        check_loss_type(cfg.loss_type)
        return
    if cfg.network_type != "flow":
        raise ValueError(f"network_type {cfg.network_type!r}: want 'flow', 'inpainting' "
                         "or 'twostage'")
    check_trainable(cfg.model)


def build_net(cfg: config_lib.Config) -> torch.nn.Module:
    """The config's flow net (or inpainting generator: ``gated_org`` with
    ``org``, ``remat`` for the gated ones), seeded from ``cfg.seed``."""
    gen = torch.Generator().manual_seed(cfg.seed)
    if cfg.network_type == "inpainting":
        key = "gated_org" if cfg.org else cfg.model
        kwargs = {"remat": True} if cfg.remat and "gated" in key else {}
        return registry.build("inpainting", key, generator=gen, **kwargs)
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
    composite ``recon * occ + image * (1 - occ)``. Of a GAN run's pair, the
    generator's."""
    if isinstance(state, tuple):
        state = state[0]
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
    gan = cfg.network_type == "inpainting" and cfg.adversarial_loss
    if gan:
        dis = registry.build("discriminator", "gated_org" if cfg.org else "gated",
                             generator=torch.Generator().manual_seed(1))
        # D trains at 4x the G learning rate, as the JAX CLI sets it
        state = (state, create_train_state(dis, 4 * cfg.learning_rate, device=device))
        train_step = make_gan_inpainting_step(cfg.as_hparams())
        _, stage_eval = make_inpainting_stage_step({**cfg.as_hparams(), "loss_type": "pixel-wise"})

        def eval_step(pair, batch):
            return stage_eval(pair[0], batch)

        show = inpaint_viz_fn
    elif cfg.network_type == "inpainting":
        train_step, eval_step = make_inpainting_stage_step(cfg.as_hparams())
        show = inpaint_viz_fn
    else:
        train_step, eval_step = make_unsupervised_flow_step(cfg.as_hparams())
        show = viz_fn
    state = loop.fit(cfg, state, train_step, eval_step, train_loader, val_loader,
                     viz_fn=show)
    fit_s = time.perf_counter() - t0
    steps = (state[0] if gan else state).step
    if gan:
        gen_path = os.path.join(cfg.checkpoint_dir, "generator")
        save_pytree(gen_path, {"params": state[0].model.state_dict()})
        print("generator checkpoint:", gen_path)
    results = loop.evaluate(cfg, state, eval_step, test_loader)
    peak = (f"; peak memory {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB"
            if device.type == "cuda" else "")
    print(f"fit: {steps} steps of {cfg.batch_size} pairs in {fit_s:.1f} s wall on "
          f"{device} ({steps * cfg.batch_size / fit_s:.2f} pairs/s, the data's "
          f"generation, validation, panels and checkpoints included){peak}")
    print("test:", results)
    return results


if __name__ == "__main__":
    main()
