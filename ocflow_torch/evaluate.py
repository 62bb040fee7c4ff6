"""Evaluation CLI of the port (``evaluate.py`` of the repository): flow
quality over a dataset, EPE and, for a flow+occlusion net, occlusion F1.

    python -m ocflow_torch.evaluate --task flow --model pwc \\
        --dataset MpiSintelClean --root /data/sintel/training [--checkpoint CKPT]
    python -m ocflow_torch.evaluate --task flow_occ --model flowoccnetc \\
        --dataset MpiSintelFlowOccClean --root /data/sintel/training

Builds the network ``models.load_model(task, model)`` (seeded from 0, or the
``params`` of a port checkpoint), serves it eagerly in fp32 and eval mode
with full fp32 cuDNN convolutions, as the JAX CLI serves ``net.apply``
(FlowNetCV's cost volumes and the FlowNetC family's on the hand-written
kernel), batch by batch from the loader (``--batch_size``, the last batch
ragged), and prints one JSON line: the mean over batches of each batch's
EPE (``metrics.evaluate_flow``) and, with ``--task flow_occ`` on a dataset
with occlusion masks, of its ``occlusion_f1``. Runs on ``cuda`` unless
``--device`` says otherwise. ``--task inpainting`` and ``--with_fid`` are
ROADMAP A10.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ocflow_torch import data as data_lib
from ocflow_torch import resolve_device
from ocflow_torch.metrics import evaluate_flow, occlusion_f1
from ocflow_torch.models import load_model, predict


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Flow evaluation (PyTorch port)")
    ap.add_argument("--task", default="flow", choices=["flow", "flow_occ", "inpainting"])
    ap.add_argument("--model", default="pwc")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--dataset", default="SyntheticFlow")
    ap.add_argument("--root", default="")
    ap.add_argument("--image_size", type=int, nargs=2, default=None)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--dataset_size", type=int, default=None,
                    help="sample count for Synthetic* procedural datasets")
    ap.add_argument("--dataset_seed", type=int, default=None,
                    help="generation seed for Synthetic* datasets (a seed other than "
                    "training's gives a held-out set)")
    ap.add_argument("--with_fid", action="store_true", help="ROADMAP A10, not ported")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.task == "inpainting" or args.with_fid:
        raise NotImplementedError(
            "inpainting evaluation (PSNR, SSIM, FID) is ROADMAP A10; the port "
            "evaluates --task flow and flow_occ")
    dev = resolve_device(args.device)

    # as the JAX CLI: the procedural datasets take a size and a seed (and
    # here the device they generate on), the file-backed ones a root
    kwargs = {}
    if args.dataset.startswith("Synthetic"):
        kwargs["device"] = dev
        if args.dataset_size:
            kwargs["size"] = args.dataset_size
        if args.dataset_seed is not None:
            kwargs["seed"] = args.dataset_seed
    else:
        kwargs["root"] = args.root
    if args.image_size:
        kwargs["image_size"] = tuple(args.image_size)
    ds = data_lib.build_dataset(args.dataset, **kwargs)
    loader = data_lib.DataLoader(ds, args.batch_size, drop_last=False)
    model = load_model(args.task, args.model, args.checkpoint, dev)

    epes, f1s = [], []
    for batch in data_lib.device_iterator(loader, dev):
        flow, occ = predict(model, batch["images"])
        epes.append(float(evaluate_flow(batch["flow"], flow)))
        if args.task == "flow_occ" and "occ" in batch:
            f1s.append(float(occlusion_f1(occ, batch["occ"])))
    results = {"epe": float(np.mean(epes))}
    if f1s:
        results["occlusion_f1"] = float(np.mean(f1s))
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
