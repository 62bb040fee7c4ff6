"""Evaluation CLI of the port (``evaluate.py`` of the repository): flow
quality over a dataset, EPE and, for a flow+occlusion net, occlusion F1;
or inpainting quality, PSNR and SSIM.

    python -m ocflow_torch.evaluate --task flow --model pwc \\
        --dataset MpiSintelClean --root /data/sintel/training [--checkpoint CKPT]
    python -m ocflow_torch.evaluate --task flow_occ --model flowoccnetc \\
        --dataset MpiSintelFlowOccClean --root /data/sintel/training
    python -m ocflow_torch.evaluate --task inpainting --model simple \\
        --dataset MpiSintelCleanInpainting --root /data/sintel/training

Builds the network ``models.load_model(task, model)`` (seeded from 0, or the
``params`` of a port checkpoint: a GAN run's exported ``generator`` or its
pair checkpoint), serves it eagerly in fp32 and eval mode
with full fp32 cuDNN convolutions, as the JAX CLI serves ``net.apply``
(FlowNetCV's cost volumes and the FlowNetC family's on the hand-written
kernel), batch by batch from the loader (``--batch_size``, the last batch
ragged), and prints one JSON line: the mean over batches of each batch's
EPE (``metrics.evaluate_flow``) and, with ``--task flow_occ`` on a dataset
with occlusion masks, of its ``occlusion_f1``. ``--task inpainting`` applies
the inpainting net to each batch's complete ``image`` and its mask ``occ``
(the net zeroes the hole itself), as the JAX CLI does, and prints the mean
over batches of each batch's PSNR and SSIM of ``recon * occ + image * (1 -
occ)`` (``metrics.calculate_psnr``, ``calculate_ssim``); with ``--with_fid``
also the FID between the real and the completed images on InceptionV3's
pool features (the images resized to 299x299, bilinear): the pytorch-fid
network from ``--inception_weights`` (the ``.npz`` of
``metrics.inception.convert_torch_inception``), or, with
``--allow_random_fid``, a seeded network whose FID only ranks runs against
each other (a warning says so on stderr). ``--with_fid`` with neither
refuses, as the JAX CLI does. Runs on ``cuda`` unless ``--device`` says
otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

import torch

from ocflow_torch import data as data_lib
from ocflow_torch import full_fp32_convs, resolve_device
from ocflow_torch.metrics import (calculate_fid, calculate_psnr, calculate_ssim, evaluate_flow,
                                  init_inception, occlusion_f1)
from ocflow_torch.models import load_model, predict
from ocflow_torch.ops.resize import resize_bilinear


def inpaint_fn(model):
    """The eager fp32 inpainting of ``(imgs, masks)`` NHWC (the refined
    output of a ``(coarse, refined)`` generator), no gradients, full fp32
    convolutions."""

    def inpaint(imgs, masks):
        with torch.no_grad(), full_fp32_convs(torch.float32):
            out = model(imgs.float(), masks.float())
        return out[1] if isinstance(out, tuple) else out

    return inpaint


def inception_features(net):
    """``[B, H, W, 3]`` -> InceptionV3's pool features ``[B, 2048]`` of the
    images resized to 299x299 (bilinear, ``align_corners=False``), fp32,
    no gradients."""

    def extract(imgs):
        with torch.no_grad(), full_fp32_convs(torch.float32):
            x = resize_bilinear(imgs.float().permute(0, 3, 1, 2), 299, 299)
            return net(x.permute(0, 2, 3, 1))[0]

    return extract


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Flow and inpainting evaluation (PyTorch port)")
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
    ap.add_argument("--with_fid", action="store_true")
    ap.add_argument("--inception_weights", default="",
                    help="npz from ocflow_torch.metrics.inception.convert_torch_inception "
                    "(the pytorch-fid weights); required for --with_fid")
    ap.add_argument("--allow_random_fid", action="store_true",
                    help="compute FID on RANDOM inception features (relative comparisons "
                    "only; absolute values are meaningless)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.with_fid and not args.inception_weights and not args.allow_random_fid:
        ap.error("--with_fid needs --inception_weights (convert the pytorch-fid checkpoint "
                 "with ocflow_torch.metrics.inception.convert_torch_inception); pass "
                 "--allow_random_fid to knowingly compute a random-feature FID")
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

    if args.task == "inpainting":
        # host batches, as the JAX CLI's list(loader): each goes to the card
        # only while the metrics run the net on it (the procedural datasets,
        # made on the card, come back as they are made)
        batches = [{k: v.cpu() for k, v in b.items()} for b in loader]
        results = {"psnr": calculate_psnr(inpaint_fn(model), batches, device=dev),
                   "ssim": calculate_ssim(inpaint_fn(model), batches, device=dev)}
        if args.with_fid:
            if not args.inception_weights:
                print("WARNING: computing FID with RANDOM inception features "
                      "(--allow_random_fid); the absolute value is meaningless", file=sys.stderr)
            net = init_inception(weights_path=args.inception_weights or None, device=dev)
            results["fid"] = calculate_fid(inpaint_fn(model), batches, inception_features(net),
                                           device=dev)
        print(json.dumps(results))
        return results
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
