"""Where the FlowNetC family's serving forward, or an unsupervised train
step of a flow net, spends its time on the card.

Runs the fp32 eval forward of a seeded net of the family
(``bench.make_flownetc_inputs``: B=8, 448x1024, seed 0) or, with
``--unsupervised``, one occlusion-aware unsupervised train step of the
seeded registry net ``--model`` (``flownetc``, ``flownet`` or ``pwcnet``;
``configs/longrun_synthetic.yaml``'s hparams, a B=8 448x1024
``SyntheticFlowWarp`` batch) and prints one JSON line with:

- ``ms_per_batch``: device ms per forward or step (CUDA events over
  ``--iters`` calls after 3 warm-up calls), and ``host_ms_per_batch``, the
  host's time to issue one (a host time near the device time means the
  host paces the card);
- ``kernel_ms_per_batch`` and ``busy_share``: the device time of every
  kernel in a ``torch.profiler`` trace of the same forwards, per forward
  and as a share of their device time (the device-side span of a
  ``record_function`` range, such as ``ops.attention.RANGE``, is not a
  kernel and is left out);
- ``by_kind``: that kernel time summed by kind (cost volume, convolution
  forward and backward, BatchNorm, LeakyReLU, concatenation, copies,
  gathers and scatters (warps, the range map), the optimizer, the rest),
  the kind read from the kernel's name; a GEMM outside cuDNN is
  ``matmul`` (the resize's dense matrices); ``top``: the kernels with the
  most device time.

Usage: ``python -m ocflow_torch.tools.flownetc_profile [--model flownetc]
[--iters 10]``, ``python -m ocflow_torch.tools.flownetc_profile
--unsupervised --model flownetc|flownet|pwcnet``.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ocflow_torch.bench import (BATCH, HEIGHT, SEED, WIDTH, cuda_ms, gpu_info,
                                make_flownetc_inputs)
from ocflow_torch.models import FlowNetC, FlowOccNetC, OcclusionNetC
from ocflow_torch.ops.attention import RANGE
from ocflow_torch.tools.train_profile import _device_us

MODELS = {"flownetc": FlowNetC, "occnetc": OcclusionNetC, "flowoccnetc": FlowOccNetC}
# the registry's flow nets whose unsupervised step launches a kernel
UNSUPERVISED = ("flownetc", "flownet", "pwcnet")
# kernel-name fragments of each kind, tried in this order
KINDS = (("cost_volume", ("cost_volume",)),
         ("batchnorm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
         ("leaky_relu", ("leaky",)),
         ("concat", ("CatArray", "cat_")),
         ("conv", ("conv", "xmma", "cudnn", "gemm", "fprop", "dgrad", "wgrad", "winograd",
                   "fft", "region_transform", "implicit", "sm90")),
         ("optimizer", ("multi_tensor", "adam")),
         ("gather_scatter", ("index", "gather", "scatter")),
         ("copy", ("copy", "nchwToNhwc", "nhwcToNchw", "transpose")))


# cuBLAS / CUTLASS GEMMs (the dense-matrix bilinear resize): a GEMM kernel
# whose name carries none of these convolution fragments
CONV_GEMM = ("fprop", "dgrad", "wgrad", "implicit", "conv", "cudnn", "winograd")


def kind_of(name: str) -> str:
    low = name.lower()
    if ("gemm" in low or "gemv" in low) and not any(p in low for p in CONV_GEMM):
        return "matmul"
    for kind, parts in KINDS:
        if any(p.lower() in low for p in parts):
            return kind
    return "other"


def profile_forward(model, x, iters: int) -> dict:
    def forward():
        with torch.no_grad():
            model(x)

    return profile_fn(forward, x.shape[0], iters)


def unsupervised_step(key: str):
    """One occlusion-aware unsupervised train step of the seeded registry
    net ``key`` on a B=8 448x1024 ``SyntheticFlowWarp`` batch, as a
    callable (each call is a step: Adam moves the weights)."""
    from ocflow_torch.data import DataLoader, build_dataset
    from ocflow_torch.models import registry
    from ocflow_torch.train import config as config_lib
    from ocflow_torch.train import create_train_state, make_unsupervised_flow_step

    hp = {**config_lib.load_config("configs/longrun_synthetic.yaml").as_hparams(),
          "model": key}
    model = registry.build("flow", key, generator=torch.Generator().manual_seed(SEED))
    state = create_train_state(model, hp["learning_rate"], device="cuda")
    ds = build_dataset("SyntheticFlowWarp", size=BATCH, image_size=(HEIGHT, WIDTH),
                       device="cuda")
    batch = {k: t.cuda() for k, t in next(iter(DataLoader(ds, BATCH))).items()}
    train_step, _ = make_unsupervised_flow_step(hp)
    return lambda: train_step(state, batch)


def profile_fn(forward, batch: int, iters: int) -> dict:
    """``forward()`` timed and traced as the module docstring says."""
    for _ in range(3):
        forward()
    ms = cuda_ms(forward, iters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        forward()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()

    from torch.profiler import ProfilerActivity, profile

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(iters):
            forward()
        end.record()
        end.synchronize()
    traced_ms = start.elapsed_time(end) / iters
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA") and _device_us(e) > 0
               and e.key != RANGE]
    kernel_ms = sum(_device_us(e) for e in kernels) / 1e3 / iters
    by_kind: dict[str, float] = {}
    for e in kernels:
        k = kind_of(e.key)
        by_kind[k] = by_kind.get(k, 0.0) + _device_us(e) / 1e3 / iters
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    return {
        "ms_per_batch": ms, "pairs_per_sec": batch * 1e3 / ms,
        "host_ms_per_batch": host_ms, "traced_ms_per_batch": traced_ms,
        "kernel_ms_per_batch": kernel_ms,
        "busy_share": kernel_ms / traced_ms if traced_ms else None,
        "by_kind": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
        "top": [{"name": e.key[:90], "kind": kind_of(e.key),
                 "ms_per_batch": _device_us(e) / 1e3 / iters,
                 "calls_per_batch": e.count / iters} for e in top],
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted({*MODELS, *UNSUPERVISED}), default="flownetc")
    ap.add_argument("--unsupervised", action="store_true",
                    help="profile one unsupervised train step of --model (flownetc, "
                    "flownet or pwcnet) instead of the FlowNetC family's forward")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if args.unsupervised:
        if args.model not in UNSUPERVISED:
            ap.error(f"--unsupervised takes --model {' | '.join(UNSUPERVISED)}")
        prof = profile_fn(unsupervised_step(args.model), BATCH, args.iters)
    elif args.model not in MODELS:
        ap.error(f"the forward takes --model {' | '.join(MODELS)}")
    else:
        model, x = make_flownetc_inputs(BATCH, HEIGHT, WIDTH, "cuda", SEED,
                                        MODELS[args.model])
        prof = profile_forward(model, x, args.iters)
    name, _, limit = gpu_info().partition(", ")
    result = {"model": args.model, "unsupervised_step": args.unsupervised, **prof,
              "batch": BATCH, "device": {"name": name, "power_limit": limit}}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
