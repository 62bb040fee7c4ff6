"""Supervised trainer CLI of the port (the repository's ``train.py``):

    python -m ocflow_torch.train --config configs/supervised.yaml \\
        [--max_epochs N] [--device cuda|cpu]

Dispatches ``network_type`` ``flow`` | ``occ`` | ``flow-occ`` |
``inpainting`` to the registry's family (``flow``, ``occ``, ``flow_occ``,
``inpainting``; ``model: pwc`` is ``FlowNetCV(displacement=cfg.displacement)``,
computing in ``compute_dtype`` over fp32 weights) and the matching
supervised step of ``train.steps`` (``train.steps_inpainting`` for
``inpainting``: frame 2 warped by the ground-truth flow, the occluded
region completed, the masked L1 against frame 1), builds the loaders (``train.loop.make_loaders``), a net
seeded from ``cfg.seed`` with Adam at ``cfg.learning_rate`` (with
``find_best_lr``: first the range test of ``train.lr_finder``, whose
suggestion it prints and then trains at, from fresh weights), runs
``train.loop.fit`` (CSV, TensorBoard, the best checkpoint, early stopping)
and ``train.loop.evaluate`` on the test split, printing ``test: {...}``.
``eflownet`` and ``eflownet2`` raise ``NotImplementedError``: the JAX steps
pass no dropout rng, so the reference cannot train them either
(``train.steps.check_trainable``). ``inpainting`` trains any generator
of the registry's family (``simple``, ``gated``, ``gated_org``). Runs on
``cuda`` unless ``--device`` says otherwise.

Under ``torchrun`` (``--dist_backend nccl | gloo``, as
``ocflow_torch.train_unsupervised``) every regime trains data-parallel,
BatchNorm nets included (the global batch's statistics); ``find_best_lr``
raises there: the JAX ``lr_find`` runs each process on its own shard
without a mesh, so it defines no range test over several processes.
"""

from __future__ import annotations

import argparse

import torch

from ocflow_torch import parallel, resolve_device
from ocflow_torch.models import registry
from ocflow_torch.models.pwc_net import FlowNetCV
from ocflow_torch.train import config as config_lib
from ocflow_torch.train import loop, steps, steps_inpainting
from ocflow_torch.train.lr_finder import lr_find
from ocflow_torch.train.state import create_train_state
from ocflow_torch.train.steps import check_trainable

# network_type -> (registry family, step factory)
REGIMES = {
    "flow": ("flow", steps.make_supervised_flow_step),
    "occ": ("occ", steps.make_supervised_occ_step),
    "flow-occ": ("flow_occ", steps.make_supervised_flow_occ_step),
    "inpainting": ("inpainting", steps_inpainting.make_supervised_inpainting_step),
}


def build_net(cfg: config_lib.Config) -> torch.nn.Module:
    """The config's network, seeded from ``cfg.seed``."""
    gen = torch.Generator().manual_seed(cfg.seed)
    if cfg.network_type == "flow" and cfg.model == "pwc":
        return FlowNetCV(displacement=cfg.displacement, generator=gen)
    return registry.build(REGIMES[cfg.network_type][0], cfg.model, generator=gen)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Supervised trainer (PyTorch port)")
    ap.add_argument("--config", default="configs/supervised.yaml")
    ap.add_argument("--max_epochs", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dist_backend", choices=parallel.BACKENDS, default=None,
                    help="under torchrun: nccl (default on CUDA) or gloo (the CPU, or ranks "
                         "sharing a GPU)")
    args = ap.parse_args(argv)

    cfg = config_lib.load_config(args.config)
    if args.max_epochs is not None:
        cfg.max_epochs = args.max_epochs
    if cfg.network_type not in REGIMES:
        raise ValueError(f"network_type {cfg.network_type!r}: want one of "
                         f"{sorted(REGIMES)}")
    check_trainable(cfg.model)
    with parallel.process_group(args.dist_backend, args.device) as multi:
        if multi and cfg.find_best_lr:
            raise NotImplementedError("find_best_lr over several processes: run the range "
                                      "test on one")
        device = parallel.local_device(args.device) if multi else resolve_device(args.device)
        mesh = parallel.default_mesh(cfg.mesh_shape, device)

        train_loader, val_loader, test_loader = loop.make_loaders(cfg, device, mesh)
        train_step, eval_step = REGIMES[cfg.network_type][1](
            {**cfg.as_hparams(), "_fast_mesh": mesh})

        def build_state(learning_rate: float):
            return create_train_state(build_net(cfg), learning_rate, device=device)

        if cfg.find_best_lr:
            suggested, _, _ = lr_find(build_state, lambda: (train_step, eval_step),
                                      train_loader, num_steps=100)
            print("find_best_lr suggestion:", suggested)
            cfg.learning_rate = suggested

        state = build_state(cfg.learning_rate)
        state = loop.fit(cfg, state, train_step, eval_step, train_loader, val_loader,
                         mesh=mesh)
        results = loop.evaluate(cfg, state, eval_step, test_loader, mesh=mesh)
        if parallel.is_main_process():
            print("test:", results)
        return results


if __name__ == "__main__":
    main()
