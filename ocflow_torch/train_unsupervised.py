"""Unsupervised trainer CLI of the port (the repository's
``train_unsupervised.py``): the ``network_type: flow`` regime,
occlusion-aware through the config's hparams, for every flow net of the
registry that the JAX package can train; the ``network_type: inpainting``
stage and GAN regimes; and the ``network_type: twostage`` pipelines.

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
the generator in eval mode. ``loss_type: vgg`` adds the perceptual loss on
a frozen VGG16 (``losses.perceptual.init_vgg16``, seeded from 0 or loaded
from ``vgg_weights``) to the stage step and makes it the GAN step's content
term.

``network_type: twostage`` trains the occlusion net of a two-stage pipeline
(:func:`build_two_stage`). With ``with_gt_flow: true`` (TwoStageModelGC,
``train.steps_two_stage.make_two_stage_gc_step``): the ground-truth flow
warps frame 2, a ``SimpleOcclusionNet`` (seeded from ``cfg.seed``) predicts
the occlusion and the inpainter of ``inpainting_stage`` (``simple``,
``gated`` (the default), ``gated_org``; seeded from 1; ``remat`` for the
gated ones) completes the warp; the state's model is ``nn.ModuleDict({'occ',
'inpaint'})`` with the gated Adam of ``make_two_stage_gc_optimizer``, the
inpainter frozen for ``unfreeze_epoch`` epochs, then trained at
``finetune_lr``; ``using_pretrained_inpainting`` with ``inpainting_root``
splices the ``params`` of a port checkpoint (a GAN run's exported
``generator``) into the inpainter. The validation panel ``pipeline`` (the
frames, the true flow, the warp, the occlusion, the completed frame) comes
from both nets in eval mode. With ``with_gt_flow: false`` (TwoStageModel):
a frozen ``SimpleFlowNet`` (seeded from ``cfg.seed``, or the ``params`` of
the port checkpoint at ``flow_root``) and a trainable ``SimpleOcclusionNet``
seeded from 2, on ``make_two_stage_step`` with the frozen net passed
through ``fit``'s ``step_args`` (the reference's frozen inpainter feeds no
number, so none is built and ``inpainting_root`` is not read). Runs on
``cuda`` unless ``--device`` says otherwise; on the card the run ends by
printing its peak memory.

Several processes (every ``network_type``): launched by ``torchrun``, each
rank joins the group from its environment (``parallel.initialize``,
``--dist_backend nccl`` by default on CUDA, ``gloo`` on the CPU and for
ranks that share a GPU) and runs on ``cuda:LOCAL_RANK`` (gloo: ``LOCAL_RANK
% device_count``); ``batch_size`` is the global batch, each rank trains on
its block with the global batch's statistics (BatchNorm, the eager
FlowNetCV's feature moments), and only rank 0 prints, logs and saves (a GAN
run's exported generator too)::

    torchrun --nproc_per_node 4 -m ocflow_torch.train_unsupervised --config C
    torchrun --nproc_per_node 2 -m ocflow_torch.train_unsupervised --config C \\
        --dist_backend gloo          # two ranks sharing one GPU
"""

from __future__ import annotations

import argparse
import os
import time

import torch
from torch import nn

from ocflow_torch import parallel, resolve_device
from ocflow_torch.losses.perceptual import init_vgg16
from ocflow_torch.models import registry
from ocflow_torch.models.occlusion_nets import SimpleOcclusionNet
from ocflow_torch.models.pwc_net import FlowNetCV
from ocflow_torch.ops import warp
from ocflow_torch.train import config as config_lib
from ocflow_torch.train import loop
from ocflow_torch.train.state import TrainState, create_train_state
from ocflow_torch.train.steps import (_apply_flow_net, check_trainable,
                                     make_unsupervised_flow_step)
from ocflow_torch.train.steps_inpainting import (_apply_generator, make_gan_inpainting_step,
                                                 make_inpainting_stage_step)
from ocflow_torch.train.steps_two_stage import (_warp_nhwc, make_two_stage_gc_optimizer,
                                                make_two_stage_gc_step, make_two_stage_step)
from ocflow_torch.utils import panels
from ocflow_torch.utils.checkpoint import load_pytree, save_pytree

def check_supported(cfg: config_lib.Config) -> None:
    """Refuse what the port cannot train, saying why."""
    if cfg.network_type in ("inpainting", "twostage"):
        return
    if cfg.network_type != "flow":
        raise ValueError(f"network_type {cfg.network_type!r}: want 'flow', 'inpainting' "
                         "or 'twostage'")
    check_trainable(cfg.model)


def build_net(cfg: config_lib.Config) -> torch.nn.Module:
    """The config's flow net (or inpainting generator: ``gated_org`` with
    ``org``, ``remat`` for the gated ones), seeded from ``cfg.seed``."""
    gen = _seeded(cfg.seed)
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


def _seeded(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def load_params(path: str) -> dict:
    """The ``params`` (a ``state_dict``) of a port checkpoint: a train
    state's, an exported generator's, or the generator's of a GAN run's
    pair checkpoint."""
    tree = load_pytree(path)
    return (tree[0] if isinstance(tree, (list, tuple)) else tree)["params"]


def build_two_stage(cfg: config_lib.Config, steps_per_epoch: int, device, vgg=None,
                    mesh=None):
    """``(state, train_step, eval_step, step_args)`` of ``network_type:
    twostage`` (the module docstring), the steps built for ``mesh``."""
    hparams = {**cfg.as_hparams(), "_fast_mesh": mesh}
    if not cfg.with_gt_flow:
        # the reference's frozen inpainter feeds nothing of the loss (dead
        # under jax.jit): no inpainter is built here, so inpainting_root
        # changes nothing in this branch, as it changes no number there
        flow_net = registry.build("flow", "simple", generator=_seeded(cfg.seed))
        if cfg.flow_root:
            flow_net.load_state_dict(load_params(cfg.flow_root))
        frozen = {"flow": flow_net.to(device).eval()}
        state = create_train_state(SimpleOcclusionNet(generator=_seeded(2)),
                                   cfg.learning_rate, device=device)
        train_step, eval_step = make_two_stage_step(hparams)
        return state, train_step, eval_step, (frozen,)
    key = cfg.get("inpainting_stage", "gated")  # the inpainter's registry key
    # the GC step backprops through the (gated) inpainter from the first
    # step: remat matters here as in the inpainting regime
    kwargs = {"remat": True} if cfg.remat and "gated" in key else {}
    inp_net = registry.build("inpainting", key, generator=_seeded(1), **kwargs)
    if cfg.using_pretrained_inpainting and cfg.inpainting_root:
        inp_net.load_state_dict(load_params(cfg.inpainting_root))
    pair = nn.ModuleDict({"occ": SimpleOcclusionNet(generator=_seeded(cfg.seed)),
                          "inpaint": inp_net}).to(device=device, dtype=torch.float32)
    state = TrainState(pair, make_two_stage_gc_optimizer(
        pair, cfg.learning_rate, cfg.finetune_lr,
        unfreeze_step=cfg.unfreeze_epoch * max(steps_per_epoch, 1)))
    train_step, eval_step = make_two_stage_gc_step(hparams, vgg)
    return state, train_step, eval_step, ()


def pipeline_viz_fn(state, batch) -> dict:
    """The validation panel ``pipeline`` of the first pair of a batch
    (TwoStageModelGC): the frames, the true flow's colours, frame 2 warped
    by it, the occlusion and the completed frame, from both nets in eval
    mode without gradients (the model's mode is given back)."""
    imgs, flow = batch["images"][:1].float(), batch["flow"][:1].float()
    model = state.model
    training = model.training
    model.eval()
    try:
        with torch.no_grad():
            warped = _warp_nhwc(imgs[..., 3:], flow)
            occ = model["occ"](imgs)
            completed = _apply_generator(model["inpaint"], warped, occ)[1]
    finally:
        model.train(training)
    host = [t[0].float().cpu().numpy() for t in (imgs[..., :3], imgs[..., 3:], flow, warped,
                                                 occ, completed)]
    return {"pipeline": panels.pipeline_panel(*host)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Unsupervised trainer (PyTorch port)")
    ap.add_argument("--config", default="configs/longrun_synthetic.yaml")
    ap.add_argument("--max_epochs", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dist_backend", choices=parallel.BACKENDS, default=None,
                    help="under torchrun: nccl (default on CUDA) or gloo (the CPU, or ranks "
                         "sharing a GPU)")
    args = ap.parse_args(argv)

    cfg = config_lib.load_config(args.config)
    if args.max_epochs is not None:
        cfg.max_epochs = args.max_epochs
    check_supported(cfg)
    with parallel.process_group(args.dist_backend, args.device) as multi:
        device = parallel.local_device(args.device) if multi else resolve_device(args.device)
        return _run(cfg, device, parallel.default_mesh(cfg.mesh_shape, device))


def _run(cfg: config_lib.Config, device: torch.device, mesh) -> dict:
    """The run of :func:`main` on ``device`` (over ``mesh``'s ranks, or one)."""
    main_rank = parallel.is_main_process()
    t0 = time.perf_counter()
    train_loader, val_loader, test_loader = loop.make_loaders(cfg, device, mesh)
    vgg = (init_vgg16(_seeded(0), cfg.vgg_weights or None, device)
           if cfg.loss_type == "vgg" else None)
    step_args = ()
    gan = cfg.network_type == "inpainting" and cfg.adversarial_loss
    hparams = {**cfg.as_hparams(), "_fast_mesh": mesh}
    if cfg.network_type == "twostage":
        state, train_step, eval_step, step_args = build_two_stage(
            cfg, len(train_loader), device, vgg, mesh)
        show = pipeline_viz_fn if cfg.with_gt_flow else None
    else:
        state = create_train_state(build_net(cfg), cfg.learning_rate, device=device)
    if gan:
        dis = registry.build("discriminator", "gated_org" if cfg.org else "gated",
                             generator=_seeded(1))
        # D trains at 4x the G learning rate, as the JAX CLI sets it
        state = (state, create_train_state(dis, 4 * cfg.learning_rate, device=device))
        train_step = make_gan_inpainting_step(hparams, vgg)
        _, stage_eval = make_inpainting_stage_step({**hparams, "loss_type": "pixel-wise"})

        def eval_step(pair, batch):
            return stage_eval(pair[0], batch)

        eval_step.mesh = stage_eval.mesh
        show = inpaint_viz_fn
    elif cfg.network_type == "inpainting":
        train_step, eval_step = make_inpainting_stage_step(hparams, vgg)
        show = inpaint_viz_fn
    elif cfg.network_type == "flow":
        train_step, eval_step = make_unsupervised_flow_step(hparams)
        show = viz_fn
    state = loop.fit(cfg, state, train_step, eval_step, train_loader, val_loader,
                     step_args=step_args, viz_fn=show, mesh=mesh)
    fit_s = time.perf_counter() - t0
    steps = (state[0] if gan else state).step
    if gan and main_rank:
        gen_path = os.path.join(cfg.checkpoint_dir, "generator")
        save_pytree(gen_path, {"params": state[0].model.state_dict()})
        print("generator checkpoint:", gen_path)
    results = loop.evaluate(cfg, state, eval_step, test_loader, step_args, mesh=mesh)
    if main_rank:
        peak = (f"; peak memory {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB"
                if device.type == "cuda" else "")
        ranks = f" over {mesh.size} ranks" if mesh is not None else ""
        print(f"fit: {steps} steps of {cfg.batch_size} pairs{ranks} in {fit_s:.1f} s wall on "
              f"{device} ({steps * cfg.batch_size / fit_s:.2f} pairs/s, the data's "
              f"generation, validation, panels and checkpoints included){peak}")
        print("test:", results)
    return results


if __name__ == "__main__":
    main()
