"""Benchmarks of the port: FlowNetCV serving (``fast_apply``) and training
(the occlusion-aware unsupervised step), pairs/s.

Runs 448x1024, batch 8, bf16 weights and input, random weights from a
seed; warms up, then times 20 forwards with CUDA events. Prints one
JSON line::

    {"metric": "flownetcv_448x1024_bf16_inference", "value": N,
     "unit": "pairs/sec/chip", "ms_per_batch": t, "batch": 8,
     "device": {"name": ..., "power_limit": ...}}

With ``--q8`` the decoders run W8A8, with scales from ``calibrate_q8`` on a
held-out batch (seed 1), and the metric is
``flownetcv_448x1024_w8a8_inference``.

With ``--train`` it times the training step of
``configs/longrun_synthetic.yaml`` (``train.config.LONGRUN_SYNTHETIC``:
range-map occlusion at full resolution, the fused forward ``both``, photo
4.0, smooth1 0.5, smooth2 0.0, Adam 1e-4, bf16 compute over fp32 master
weights) on a seeded random batch: 3 warm-up steps, then 10 steps timed with
CUDA events, each with its optimizer update. Metric
``flownetcv_448x1024_bf16_train_step``, with ``ms_per_step`` in place of
``ms_per_batch``.

Usage: ``python -m ocflow_torch.bench [--q8 | --train] [--device cuda]``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch
import torch.nn.functional as F

from ocflow_torch import resolve_device
from ocflow_torch.models.pwc_fast import calibrate_q8, fast_apply
from ocflow_torch.models.pwc_net import FlowNetCV
from ocflow_torch.train import (LONGRUN_SYNTHETIC, config_from_dict, create_train_state,
                                make_unsupervised_flow_step)

# the serving shape of the JAX package's bench.py: Sintel-padded, batch 8
BATCH, HEIGHT, WIDTH, SEED = 8, 448, 1024, 0
CALIB_SEED = 1  # the held-out W8A8 calibration batch, as the JAX bench
ITERS, WARMUP = 20, 3
TRAIN_ITERS, TRAIN_WARMUP = 10, 3


def gpu_info() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them (first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def make_inputs(batch: int, height: int, width: int, dtype, device,
                seed: int = 0):
    """Seeded random FlowNetCV and a ``[B, H, W, 6]`` input in [-1, 1]."""
    gen = torch.Generator().manual_seed(seed)
    model = FlowNetCV(generator=gen).to(device=device, dtype=dtype)
    x = torch.rand((batch, height, width, 6), generator=gen) * 2 - 1
    return model, x.to(device=device, dtype=dtype)


def calibration_batch(like: torch.Tensor, seed: int = CALIB_SEED) -> torch.Tensor:
    """A held-out batch of ``like``'s shape, dtype and device, uniform in
    [-1, 1] from ``seed`` (calibrating on the measured batch would flatter
    the accuracy)."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(like.shape, generator=gen) * 2 - 1
    return x.to(device=like.device, dtype=like.dtype)


def cuda_ms(fn, iters: int) -> float:
    """Mean device ms of ``fn`` over ``iters`` calls after one warm-up,
    timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def measure(model, x, q8=None, iters: int = ITERS, warmup: int = WARMUP) -> dict:
    """Mean ms per ``fast_apply`` call over ``iters`` calls after
    ``warmup``, timed with CUDA events on the card (host clock on the CPU).
    """
    def run():
        fast_apply(model, x, q8=q8, device=x.device)

    for _ in range(warmup):
        run()
    if x.device.type == "cuda":
        ms = cuda_ms(run, iters)
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        ms = (time.perf_counter() - t0) * 1e3 / iters
    return {"ms_per_batch": ms, "pairs_per_sec": x.shape[0] * 1e3 / ms}


def train_hparams() -> dict:
    """The hparams of ``configs/longrun_synthetic.yaml``."""
    return config_from_dict(LONGRUN_SYNTHETIC).as_hparams()


def smooth_images(coarse: torch.Tensor) -> torch.Tensor:
    """``[B, 8h, 8w, 6]`` frames in [-1, 1], in ``coarse``'s dtype: the
    ``[B, 6, h, w]`` noise ``coarse`` (uniform in [-1, 1]) bicubic-upsampled
    8x and clamped. Smooth like photographs, where pixel noise would make
    the photometric loss's gradient jump at every integer crossing of the
    flow."""
    img = F.interpolate(coarse, scale_factor=8, mode="bicubic", align_corners=False)
    return img.clamp(-1, 1).permute(0, 2, 3, 1).contiguous()


def make_train_inputs(batch: int, height: int, width: int, device,
                      seed: int = 0, hparams: dict | None = None):
    """A train state (seeded FlowNetCV, fp32 master weights, Adam at the
    config's learning rate), its step function and a ``{"images": [B, H, W,
    6]}`` batch of :func:`smooth_images` over (H/8, W/8) noise, both from
    ``seed``."""
    hp = train_hparams() if hparams is None else hparams
    gen = torch.Generator().manual_seed(seed)
    model = FlowNetCV(generator=gen)
    coarse = torch.rand((batch, 6, height // 8, width // 8), generator=gen) * 2 - 1
    x = smooth_images(coarse).to(resolve_device(device))
    state = create_train_state(model, hp["learning_rate"], device=device)
    train_step, _ = make_unsupervised_flow_step(hp)
    return state, train_step, {"images": x}


def measure_train(state, train_step, batch, iters: int = TRAIN_ITERS,
                  warmup: int = TRAIN_WARMUP) -> dict:
    """Mean ms per training step (forward, backward, Adam update) over
    ``iters`` steps after ``warmup``, CUDA events on the card (host clock
    on the CPU)."""
    def run():
        train_step(state, batch)

    for _ in range(warmup):
        run()
    if state.device.type == "cuda":
        ms = cuda_ms(run, iters)
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        ms = (time.perf_counter() - t0) * 1e3 / iters
    b = batch["images"].shape[0]
    return {"ms_per_step": ms, "pairs_per_sec": b * 1e3 / ms}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--q8", action="store_true",
                      help="W8A8 decoders, scales calibrated on a held-out batch")
    mode.add_argument("--train", action="store_true",
                      help="the occlusion-aware training step (longrun_synthetic.yaml)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.train:
        res = measure_train(*make_train_inputs(BATCH, HEIGHT, WIDTH, dev, SEED))
        metric, per = "train_step", {"ms_per_step": res["ms_per_step"]}
    else:
        model, x = make_inputs(BATCH, HEIGHT, WIDTH, torch.bfloat16, dev, SEED)
        q8 = calibrate_q8(model, calibration_batch(x), device=dev) if args.q8 else None
        res = measure(model, x, q8)
        metric = "inference"
        per = {"ms_per_batch": res["ms_per_batch"]}
    if dev.type == "cuda":
        name, _, limit = gpu_info().partition(", ")
        device = {"name": name, "power_limit": limit}
    else:
        device = {"name": "cpu", "power_limit": None}
    result = {
        "metric": f"flownetcv_{HEIGHT}x{WIDTH}_{'w8a8' if args.q8 else 'bf16'}_{metric}",
        "value": res["pairs_per_sec"],
        "unit": "pairs/sec/chip" if dev.type == "cuda" else "pairs/sec/cpu",
        **per,
        "batch": BATCH,
        "device": device,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
