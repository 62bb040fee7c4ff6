"""Where a conv-group kernel's time goes, conv by conv, on the card.

Times each conv of the bf16 serving forward's conv groups (FlowNetCV, B=8
448x1024, seeded weights) with ``csrc/conv_group.cu`` as it is and with
variants of it; with ``--q8``, each int8 conv of the W8A8 forward's groups
(scales calibrated on the held-out seed-1 batch) with
``csrc/conv_group_q8.cu`` instead.

- ``--remove PART``: the staged kernel with one part taken out of its
  source text (``copy``: the per-tap window copy into the X slab;
  ``staging``: the halo tile's fill; ``weights``: the weight-slab loads;
  ``mma``: the tensor-core products). Such a kernel computes nothing
  useful; only its time means something. The time a part costs is the
  kernel's time less the time without it, and the parts overlap, so those
  differences do not add up to the kernel's time.
- ``--source NAME=PATH``: another version of the kernel's source (the same
  C entry point).
- ``--tile-cap N``: the staged tile capped at N columns (``128 // C`` rows).

Each variant is built aside with nvcc (under ``build/``). Prints, per group
and variant, the ms of each conv and their sum beside the card's name and
power limit.

Usage: ``python -m ocflow_torch.tools.conv_ablation [--q8] [--remove copy
staging weights mma] [--source NAME=PATH ...] [--tile-cap N ...]``.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from ocflow_torch.bench import (BATCH, HEIGHT, SEED, WIDTH, calibration_batch, cuda_ms,
                                gpu_info, make_inputs)
from ocflow_torch.kernels import _build, conv_chain, conv_chain_q8
from ocflow_torch.models import pwc_fast

ITERS = 10
# the source text each removal takes out of the staged kernel's K loop (the
# staged bf16 and int8 kernels name their parts alike)
REMOVALS = {
    "copy": [("      window(tap);\n", "")],
    "staging": [("    stage(c0);\n", "")],
    "weights": [("load_a(c0, tap + 1);", ";"), ("load_a(c0 + ST_CC, 0);", ";")],
    "mma": [("wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);", ";")],
}


def _compile(name: str, text: str, real, q8: bool):
    """``text`` built as ``build/.../ablation/lib<name>.so``; its C entry
    point with the argument types of ``real``, the kernel's."""
    out_dir = _build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    src.write_text(text)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build._CSRC),
                           "-o", str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{proc.stdout}{proc.stderr}")
    fn = getattr(ctypes.CDLL(str(lib)), "ocf_conv3x3_q8" if q8 else "ocf_conv3x3")
    fn.argtypes, fn.restype = real.argtypes, real.restype
    return fn


def _removed(part: str, q8: bool = False) -> str:
    text = (_build._CSRC / ("conv_group_q8.cu" if q8 else "conv_group.cu")).read_text()
    for old, new in REMOVALS[part]:
        if text.count(old) != 1:
            raise ValueError(f"--remove {part}: {old!r} is not in the kernel once")
        text = text.replace(old, new)
    return text


def _groups(model, x, q8=None):
    """The (inputs, group) of every ``conv_group`` call of one forward, or
    with ``q8`` (W8A8 scales) of every ``conv_group_q8`` call."""
    name = "conv_group" if q8 is None else "conv_group_q8"
    calls, orig = [], getattr(pwc_fast, name)

    def record(inputs, group, *rest):
        calls.append((list(inputs), group))
        return orig(inputs, group, *rest)

    setattr(pwc_fast, name, record)
    try:
        pwc_fast.fast_apply(model, x, q8=q8)
    finally:
        setattr(pwc_fast, name, orig)
    return calls


def _conv_ms(inputs, group) -> list[float]:
    """Device ms of each conv of ``group``, launched alone."""
    b = inputs[0].shape[0]
    ho, wo = conv_chain.out_hw([tuple(t.shape[2:]) for t in inputs], group.specs)
    stripe = torch.empty((b, group.width, ho, wo), dtype=group.dtype, device=inputs[0].device)
    per = []
    for j, s in enumerate(group.specs):
        o = group.offsets[j]
        reads = [conv_chain._block(inputs, stripe, group, r) for r in s.reads]
        per.append(cuda_ms(lambda: conv_chain.launch_conv(  # noqa: B023
            reads, group.packed[j], group.biases[j], stripe[:, o:o + s.cout], s,
            "conv_ablation"), ITERS))
    return per


def _conv_ms_q8(inputs, group) -> list[float]:
    """Device ms of each int8-read conv of the W8A8 ``group``, launched alone
    (the bf16-read up-flow conv, on the bf16 kernel, left out)."""
    s8, s16 = conv_chain_q8._stripes(inputs, group)
    per = []
    for j, s in enumerate(group.specs):
        if not group.int8_read[j]:
            continue
        reads = [conv_chain_q8._block(inputs, s8, s16, group, r) for r in s.reads]
        out = conv_chain_q8._block(inputs, s8, s16, group, group.n_inputs + j)
        per.append(cuda_ms(lambda: conv_chain_q8.launch_conv_q8(  # noqa: B023
            reads, group.packed[j], group.dq[j], group.bq[j], out, s,
            "conv_ablation"), ITERS))
    return per


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--q8", action="store_true",
                    help="the int8 kernel, over the W8A8 forward's int8 convs")
    ap.add_argument("--remove", nargs="*", default=[], choices=sorted(REMOVALS))
    ap.add_argument("--source", nargs="*", default=[], metavar="NAME=PATH")
    ap.add_argument("--tile-cap", nargs="*", type=int, default=[])
    args = ap.parse_args(argv)
    mod = conv_chain_q8 if args.q8 else conv_chain
    tile_name = "staged_tile_q8" if args.q8 else "staged_tile"
    texts = {f"no-{p}": _removed(p, args.q8) for p in args.remove}
    for item in args.source:
        name, path = item.split("=", 1)
        texts[name] = open(path).read()
    real = mod._lib()  # built before the variants, which copy its argtypes
    with ThreadPoolExecutor(max(1, len(texts))) as pool:
        built = dict(zip(texts, pool.map(
            lambda kv: _compile(*kv, real, args.q8), texts.items())))
    variants = {"kernel": (real, None)}
    variants.update({f"tile-cap {c}": (real, c) for c in args.tile_cap})
    variants.update({name: (fn, None) for name, fn in built.items()})

    card = gpu_info()
    model, x = make_inputs(BATCH, HEIGHT, WIDTH, torch.bfloat16, "cuda", SEED)
    model.eval()
    with torch.no_grad():
        scales = pwc_fast.calibrate_q8(model, calibration_batch(x)) if args.q8 else None
        calls = _groups(model, x, scales)
    lib, tile = mod._lib, getattr(mod, tile_name)
    conv_ms = _conv_ms_q8 if args.q8 else _conv_ms
    result = {}
    try:
        for inputs, group in calls:
            shape = tuple(inputs[0].shape)
            print(f"group {shape}: (stride, cout) {[(s.stride, s.cout) for s in group.specs]}")
            for name, (fn, cap) in variants.items():
                mod._lib = lambda fn=fn: fn
                setattr(mod, tile_name, tile if cap is None else (
                    lambda wo, cap=cap: (min(128 // min(wo, cap), 16), min(wo, cap))))
                per = conv_ms(inputs, group)
                result.setdefault(str(shape), {})[name] = per
                print(f"  {name:16s} {sum(per):8.4f} ms: " + " ".join(f"{v:.4f}" for v in per)
                      + f" [{card}]")
    finally:
        mod._lib = lib
        setattr(mod, tile_name, tile)
    for name in variants:
        total = sum(sum(v[name]) for v in result.values())
        print(f"all groups {name:16s} {total:8.4f} ms [{card}]")
    return result


if __name__ == "__main__":
    main()
