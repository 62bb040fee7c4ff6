"""W8A8 accuracy: ``fast_apply(q8=...)`` against the eager fp32 ``FlowNetCV``.

Builds the bench's seeded FlowNetCV (random weights, seed 0) and input,
calibrates W8A8 scales on the bench's held-out batch (seed 1), and compares
both flows of ``fast_apply(q8=...)`` with the eager fp32 forward: relative
L2 error, max-abs error and max-abs relative to max|flow|, for the decoder
scales (``w8a8``) and with the encoder and context chain int8 too
(``w8a8_enc_ctx``). At batch 1 the input is the first pair of the bench's
batch. Prints one JSON line.

Usage: ``python -m ocflow_torch.tools.q8_error [--batch 8] [--dtype
bfloat16] [--device cuda]`` (448x1024; on the CPU take a small batch and
float32).
"""

from __future__ import annotations

import argparse
import json

import torch

from ocflow_torch import resolve_device
from ocflow_torch.bench import BATCH, HEIGHT, SEED, WIDTH, calibration_batch, make_inputs
from ocflow_torch.models.pwc_fast import calibrate_q8, fast_apply


def flow_errors(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """Relative L2 error, max-abs error, and max-abs over max|ref|."""
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    return {"rel_l2": ((got - ref).norm() / ref.norm()).item(),
            "max_abs": err, "max_abs_rel": err / scale, "max_ref": scale}


def q8_errors(batch: int = BATCH, height: int = HEIGHT, width: int = WIDTH,
              dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    """``{mode: {"full" | "quarter": flow_errors}}`` of the W8A8 forward in
    ``dtype`` against the eager fp32 forward, for both modes."""
    dev = resolve_device(device)
    model, x = make_inputs(batch, height, width, torch.float32, dev, SEED)
    model.eval()
    with torch.no_grad():
        ref = model(x)
    model_q, xq = model.to(dtype), x.to(dtype)  # model.to is in place; ref is kept
    xc = calibration_batch(xq)
    out = {}
    for mode, opt_in in (("w8a8", False), ("w8a8_enc_ctx", True)):
        scales = calibrate_q8(model_q, xc, encoder=opt_in, ctx=opt_in, device=dev)
        got = fast_apply(model_q, xq, q8=scales, device=dev)
        out[mode] = {name: flow_errors(g, r)
                     for name, g, r in zip(("full", "quarter"), got, ref)}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = q8_errors(args.batch, HEIGHT, WIDTH, getattr(torch, args.dtype),
                    args.device)
    print(json.dumps({"shape": [args.batch, HEIGHT, WIDTH],
                      "dtype": args.dtype, "device": args.device, **res}))
    return res


if __name__ == "__main__":
    main()
