"""W8A8 accuracy on trained weights: mean EPE against the ground-truth flow
on the test split, through the fused serving forward, for four arms.

The protocol of ``results/round5_epe_ab/eval_script.py``: restore the best
checkpoint of ``cfg.checkpoint_dir``, cast the model to bf16, calibrate
W8A8 scales (``calibrate_q8(..., encoder=True, ctx=True)``) on the first
test batch, then run ``fast_apply`` over the test split with no scales
(``bf16``), the decoders' scales (``q8_dec``), plus the context chain's
(``q8_dec+ctx``) and plus the encoder's (``q8_all``). A batch's EPE is the
mean over its pixels of |flow - gt|; an arm's is the mean over batches.
Prints one line per arm, then one JSON line.

Usage: ``python -m ocflow_torch.tools.epe_ab --config CONFIG [--step N]
[--device cuda]``.
"""

from __future__ import annotations

import argparse
import json

import torch

from ocflow_torch import resolve_device
from ocflow_torch.models.pwc_fast import calibrate_q8, fast_apply
from ocflow_torch.models.pwc_net import FlowNetCV
from ocflow_torch.train import config as config_lib
from ocflow_torch.train import loop
from ocflow_torch.utils.checkpoint import CheckpointManager


def arm_scales(scales: dict) -> dict:
    """The four arms' W8A8 scales, from scales calibrated with the encoder
    and the context chain."""
    return {"bf16": None,
            "q8_dec": {k: v for k, v in scales.items() if k not in ("enc", "ctx")},
            "q8_dec+ctx": {k: v for k, v in scales.items() if k != "enc"},
            "q8_all": scales}


def epe_arms(model: FlowNetCV, batches: list[dict], device) -> dict:
    """``{arm: mean EPE}`` of the bf16 copy of ``model`` over ``batches``
    (dicts with ``images`` and ``flow``), scales from the first batch."""
    model_b = model.to(device).bfloat16()
    xb = batches[0]["images"].to(device, torch.bfloat16)
    scales = calibrate_q8(model_b, xb, encoder=True, ctx=True, device=device)
    out = {}
    for name, q8 in arm_scales(scales).items():
        epes = []
        for b in batches:
            flow = fast_apply(model_b, b["images"].to(device, torch.bfloat16), q8=q8,
                              device=device)[0]
            epes.append(torch.linalg.vector_norm(flow - b["flow"].to(device), dim=-1).mean())
        out[name] = torch.stack(epes).mean().item()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="configs/longrun_synthetic.yaml")
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step (default: the best)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = config_lib.load_config(args.config)
    cfg.device_cache = False  # as the round-5 protocol: batches generated per pass
    _, _, test_loader = loop.make_loaders(cfg, dev)
    batches = list(test_loader)
    mgr = CheckpointManager(cfg.checkpoint_dir)
    step = mgr.best_step if args.step is None else args.step
    model = FlowNetCV(displacement=cfg.displacement)
    model.load_state_dict(mgr.restore(step)["params"])
    print(f"{len(batches)} test batches, checkpoint step {step}", flush=True)
    arms = epe_arms(model, batches, dev)
    for name, epe in arms.items():
        print(f"{name}: EPE {epe:.4f}", flush=True)
    device = "cpu"
    if dev.type == "cuda":
        from ocflow_torch.bench import gpu_info
        device = gpu_info()
    result = {"epe": arms, "checkpoint_step": step, "test_batches": len(batches),
              "device": device}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
