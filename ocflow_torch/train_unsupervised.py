"""Unsupervised trainer CLI of the port: the ``network_type: flow`` regime
of the repository's ``train_unsupervised.py``, occlusion-aware through the
config's hparams, for every flow net of the registry that the JAX package
can train.

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
cannot train them either (``train.steps.check_trainable``). The
inpainting and two-stage regimes are ROADMAP A10. Runs on ``cuda`` unless
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
from ocflow_torch.utils import panels


def check_supported(cfg: config_lib.Config) -> None:
    """Refuse what the port cannot train, saying why or where it is
    queued."""
    if cfg.network_type != "flow":
        raise NotImplementedError(
            f"network_type {cfg.network_type!r}: the port trains only 'flow'; the "
            "inpainting and two-stage regimes are ROADMAP A10")
    check_trainable(cfg.model)


def build_net(cfg: config_lib.Config) -> torch.nn.Module:
    """The config's flow net, seeded from ``cfg.seed``."""
    gen = torch.Generator().manual_seed(cfg.seed)
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


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Unsupervised flow trainer (PyTorch port)")
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
    train_step, eval_step = make_unsupervised_flow_step(cfg.as_hparams())
    state = loop.fit(cfg, state, train_step, eval_step, train_loader, val_loader,
                     viz_fn=viz_fn)
    fit_s = time.perf_counter() - t0
    results = loop.evaluate(cfg, state, eval_step, test_loader)
    print(f"fit: {state.step} steps of {cfg.batch_size} pairs in {fit_s:.1f} s wall on "
          f"{device} ({state.step * cfg.batch_size / fit_s:.2f} pairs/s, the data's "
          f"generation, validation, panels and checkpoints included)")
    print("test:", results)
    return results


if __name__ == "__main__":
    main()
