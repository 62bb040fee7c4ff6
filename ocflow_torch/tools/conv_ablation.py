"""Where a conv-group kernel's time goes, conv by conv, on the card.

Times each conv of the bf16 serving forward's conv groups (FlowNetCV, B=8
448x1024, seeded weights) with ``csrc/conv_group.cu`` as it is and with
variants of it (every stride-1 conv on its staged kernel, as
``conv_group(..., staged=True)`` runs it; ``tools.conv_tma_ablation`` times
the TMA kernels); with ``--q8``, each int8 conv of the W8A8 forward's groups
(scales calibrated on the held-out seed-1 batch) on the staged kernel of
``csrc/conv_group_q8.cu`` instead, over an NCHW copy of each group's
channels-innermost stripe (:func:`q8_conv_cases`, which also gives the int8
TMA kernel's yardsticks).

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
import dataclasses
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

from ocflow_torch.bench import (BATCH, HEIGHT, SEED, WIDTH, calibration_batch, cuda_ms,
                                gpu_info, make_inputs)
from ocflow_torch.kernels import _build, conv_chain, conv_chain_q8
from ocflow_torch.models import pwc_fast

ITERS = 10
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
INT8_OPS_PER_S = 1979e12   # H100 SXM dense int8 tensor-core peak
# the source text each removal takes out of the staged kernel's K loop (the
# staged bf16 and int8 kernels name their parts alike)
REMOVALS = {
    "copy": [("      window(tap);\n", "")],
    "staging": [("    stage(c0);\n", "")],
    "weights": [("load_a(c0, tap + 1);", ";"), ("load_a(c0 + ST_CC, 0);", ";")],
    "mma": [("wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);", ";")],
}


def _compile(name: str, text: str, real, entry: str):
    """``text`` built as ``build/.../ablation/lib<name>.so``; its C entry
    point ``entry`` with the argument types of ``real``, the kernel's."""
    out_dir = _build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    src.write_text(text)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build._CSRC),
                           "-o", str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n{proc.stdout}{proc.stderr}")
    fn = getattr(ctypes.CDLL(str(lib)), entry)
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
            "conv_ablation", staged=True), ITERS))
    return per


def q8_conv_checks(st, group) -> list[dict]:
    """Per int8-read conv of a channels-innermost W8A8 group, on the CUDA
    stripes ``st`` (:func:`conv_chain_q8.stripes_q8`, blocks as a run left
    them): ``run`` (the TMA kernel alone into the conv's block), ``out``
    (that block) and ``plain`` (:func:`conv_chain_q8.plain_conv_q8` on the
    same reads)."""
    cases = []
    for j, s in enumerate(group.specs):
        if not group.int8_read[j]:
            continue
        blocks = [conv_chain_q8._block(st.inputs, st.s8, st.s16, group, r) for r in s.reads]
        out = conv_chain_q8._block(st.inputs, st.s8, st.s16, group, group.n_inputs + j)
        cases.append({
            "j": j, "spec": s, "out": out,
            "run": lambda j=j, out=out: conv_chain_q8.launch_conv_q8_tma(
                st.s8, group, j, out, "q8 tma conv"),
            "plain": lambda blocks=blocks, j=j: conv_chain_q8.plain_conv_q8(
                torch.cat(blocks, 1), group, j),
        })
    return cases


def q8_conv_cases(inputs, group) -> list[dict]:
    """:func:`q8_conv_checks` on new stripes that one run of the group on
    ``inputs`` filled, and per conv its yardsticks: ``staged`` (the staged
    int8 kernel of ``csrc/conv_group_q8.cu`` on an NCHW copy), ``bf16_tma``
    (the bf16 TMA kernel on the codes and weights as bf16), ``cudnn`` (one
    bf16 ``F.conv2d`` over the concat of its reads), and the bound
    (``bytes_ms``: reads, weights, the fp32 epilogue vectors and the output
    moved once at 3.35 TB/s; ``ops_ms``: 2 x MACs at 1979 int8 TOP/s)."""
    st = conv_chain_q8.stripes_q8(inputs, group)
    conv_chain_q8.run_group_q8(st, group)
    b, _, h, w = st.s8.shape
    s8n = st.s8.contiguous()
    s16n = s8n.bfloat16()
    cases = q8_conv_checks(st, group)
    for c in cases:
        j, s, out = c["j"], c["spec"], c["out"]
        ranges = conv_chain_q8._read_ranges(s, group.in_offsets, group.offsets,
                                            group.in_channels, group.specs)
        reads_n = [s8n[:, o:o + n] for o, n in ranges]
        packed_n = conv_chain_q8.pack_weights_q8(group.weights[j].cpu(), True).to(s8n.device)
        reads16 = [s16n[:, o:o + n] for o, n in ranges]
        xcat = torch.cat(reads16, 1)
        out_n = torch.empty((b, s.cout, h, w), dtype=out.dtype, device=s8n.device)
        out16 = torch.empty((b, s.cout, h, w), dtype=torch.bfloat16, device=s8n.device)
        w16 = group.weights[j].bfloat16()
        packed16 = conv_chain.pack_weights(group.weights[j].float(), torch.bfloat16)
        spec16, tma16 = dataclasses.replace(s, q8=False), {}

        def bf16_tma(reads16=reads16, packed16=packed16, j=j, out16=out16, spec16=spec16,
                     tma16=tma16):
            before = conv_chain.conv_group.tma_launches
            conv_chain.launch_conv(reads16, packed16, group.bq[j], out16, spec16,
                                   "q8 yardstick bf16 tma", tma=tma16)
            if conv_chain.conv_group.tma_launches != before + 1:
                raise RuntimeError("the bf16 yardstick did not run the bf16 TMA kernel")

        nbytes = (sum(t.numel() for t in reads_n) + group.weights[j].numel() + 8 * s.cout
                  + out.numel() * out.element_size())
        ops = 2 * group.weights[j].numel() * b * h * w
        c.update({
            "staged": lambda reads_n=reads_n, packed_n=packed_n, j=j, s=s, out_n=out_n:
                conv_chain_q8.launch_conv_q8(reads_n, packed_n, group.dq[j], group.bq[j],
                                             out_n, s, "q8 yardstick staged"),
            "bf16_tma": bf16_tma,
            "cudnn": lambda xcat=xcat, w16=w16: F.conv2d(xcat, w16, None, padding=1),
            "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "ops_ms": ops / INT8_OPS_PER_S * 1e3,
            "bound_ms": max(nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S) * 1e3,
        })
    return cases


def _conv_ms_q8(inputs, group) -> list[float]:
    """Device ms of the staged int8 kernel on each int8-read conv of the
    W8A8 ``group`` (its channels-innermost stripe copied to NCHW), launched
    alone (the bf16-read up-flow conv, on the bf16 kernel, left out)."""
    return [cuda_ms(c["staged"], ITERS) for c in q8_conv_cases(inputs, group)]


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
            lambda kv: _compile(*kv, real, "ocf_conv3x3_q8" if args.q8 else "ocf_conv3x3"),
            texts.items())))
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
