"""Inference CLI of the port (``infer.py`` of the repository): flow for
each pair of consecutive frames of a folder, written as colour PNGs and,
with ``--save_flo``, as ``.flo`` files.

    python -m ocflow_torch.infer --input path/to/frames --output out/ \\
        [--model pwc] [--checkpoint CKPT] [--q8] [--save_flo]

The frames are ``ImagesFromFolder`` pairs (``--iext``, ``--image_size``),
served one pair at a time as the JAX CLI serves them. FlowNetCV (``--model
pwc``) runs the fused forward ``fast_apply`` in fp32, as the JAX CLI runs
its fused path on fp32 weights and frames; ``--q8`` calibrates W8A8 scales
on the first pair and runs the five decoders on the int8 kernel (see the
flag's help). The FlowNetC family (``flownetc``, ``flowoccnetc`` with
``--family flow_occ``) and PWCNet run their eager module in fp32 and eval
mode. The network is seeded from 0, or takes the ``params`` of a port
checkpoint. Runs on ``cuda`` unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
import os

import torch

from ocflow_torch import resolve_device
from ocflow_torch import data as data_lib
from ocflow_torch.data.flow_io import write_flo
from ocflow_torch.models import calibrate_q8, fast_apply, load_model, predict
from ocflow_torch.utils.png import write_png
from ocflow_torch.utils.viz import flow_to_image

Q8_HELP = ("W8A8 serving (--model pwc only): scales calibrated on the first pair, "
           "the five dense decoders on the int8 conv kernel and their outputs in "
           "bf16; the encoder, the cost volumes, the warps and the context network "
           "stay fp32, as in the JAX package's fused path on fp32 weights. What it "
           "costs in EPE on trained weights and gains in speed on the card: PERF.md.")


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser(description="Flow inference over a folder of frames "
                                             "(PyTorch port)")
    ap.add_argument("--model", default="pwc")
    ap.add_argument("--family", default="flow", choices=["flow", "flow_occ"])
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--input", required=True, help="folder of frames")
    ap.add_argument("--output", default="flow_out")
    ap.add_argument("--iext", default="png")
    ap.add_argument("--image_size", type=int, nargs=2, default=None)
    ap.add_argument("--save_flo", action="store_true")
    ap.add_argument("--q8", action="store_true", help=Q8_HELP)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    fused = args.family == "flow" and args.model == "pwc"
    if args.q8 and not fused:
        raise ValueError("--q8 serves FlowNetCV (--family flow --model pwc) only")
    dev = resolve_device(args.device)

    ds = data_lib.build_dataset(
        "ImagesFromFolder", root=args.input, iext=args.iext,
        image_size=tuple(args.image_size) if args.image_size else None)
    model = load_model(args.family, args.model, args.checkpoint, dev)
    q8 = None
    if args.q8:
        q8 = calibrate_q8(model, torch.from_numpy(ds[0]["images"])[None], device=dev)

    os.makedirs(args.output, exist_ok=True)
    loader = data_lib.DataLoader(ds, 1, num_workers=1, drop_last=False)
    written = []
    for i, batch in enumerate(data_lib.device_iterator(loader, dev)):
        if fused:
            flow = fast_apply(model, batch["images"], q8=q8, device=dev)[0]
        else:
            flow = predict(model, batch["images"])[0]
        flow = flow[0].cpu().numpy()
        path = os.path.join(args.output, f"flow_{i:05d}.png")
        write_png(path, flow_to_image(flow))
        written.append(path)
        if args.save_flo:
            path = os.path.join(args.output, f"flow_{i:05d}.flo")
            write_flo(path, flow)
            written.append(path)
    print(f"wrote {len(ds)} flow fields to {args.output}")
    return written


if __name__ == "__main__":
    main()
