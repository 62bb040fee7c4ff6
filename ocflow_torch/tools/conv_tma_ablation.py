"""Where the TMA conv kernel's time goes, conv by conv, on the card.

Times every bf16 conv of stride 1 and dilation 1 of the bf16 serving
forward's conv groups (FlowNetCV, B=8 448x1024, seeded weights) on
``csrc/conv_group_tma.cu`` as it is, on variants of it, on the staged kernel
of ``csrc/conv_group.cu`` and as one cuDNN call (``F.conv2d`` over the
concat of its reads, bias and LeakyReLU outside; the yardstick, never used
by the port). Device times come from calls queued behind a spin kernel
(``tools.spike_int8.queued_ms``), so they are the card's and not the host's;
the host's microseconds to issue one call are printed beside.

- ``--remove PART``: the TMA kernel with one part taken out of its source
  text (``shift``: the shift warps' windows of tap columns 0 and 2;
  ``mma``: the wgmma products). Such a kernel computes nothing useful; only
  its time means something.
- ``--source NAME=PATH``: another version of the kernel's source (the same
  C entry point).

Each variant is built aside with nvcc (under ``build/``). Prints, per group
and variant, the ms of each conv and their sum beside the card's name and
power limit; then per variant the sum over the forward.

Usage: ``python -m ocflow_torch.tools.conv_tma_ablation [--remove shift mma]
[--source NAME=PATH ...]``.
"""

from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

from ocflow_torch.bench import BATCH, HEIGHT, SEED, WIDTH, gpu_info, make_inputs
from ocflow_torch.kernels import _build, conv_chain
from ocflow_torch.tools.conv_ablation import _compile, _groups
from ocflow_torch.tools.spike_int8 import queued_ms

ITERS = 20
REMOVALS = {
    "shift": [("          shift_lines(sa, lay.box", "          if (0) shift_lines(sa, lay.box")],
    "mma": [("              wgmma_tn<NT>(d[i],", "              if (false) wgmma_tn<NT>(d[i],")],
}


def _removed(part: str) -> str:
    text = (_build._CSRC / "conv_group_tma.cu").read_text()
    for old, new in REMOVALS[part]:
        if text.count(old) != 1:
            raise ValueError(f"--remove {part}: {old!r} is not in the kernel once")
        text = text.replace(old, new)
    return text


def _convs(inputs, group):
    """``(j, reads, out)`` of each stride-1 bf16 conv of ``group`` whose
    rows TMA can read (those the routing keeps on the staged kernel too),
    over one stripe (its blocks hold whatever the last call left)."""
    b = inputs[0].shape[0]
    ho, wo = conv_chain.out_hw([tuple(t.shape[2:]) for t in inputs], group.specs)
    stripe = torch.zeros((b, group.width, ho, wo), dtype=group.dtype, device=inputs[0].device)
    for j, s in enumerate(group.specs):
        if conv_chain.is_staged(group.dtype, s) and wo % 8 == 0:
            o = group.offsets[j]
            yield j, [conv_chain._block(inputs, stripe, group, r) for r in s.reads], \
                stripe[:, o:o + s.cout]


def _cudnn(reads, group, j):
    x = torch.cat(reads, 1)
    w = group.weights[j]
    return lambda: F.conv2d(x, w, None, padding=1)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--remove", nargs="*", default=[], choices=sorted(REMOVALS))
    ap.add_argument("--source", nargs="*", default=[], metavar="NAME=PATH")
    args = ap.parse_args(argv)
    texts = {f"no-{p}": _removed(p) for p in args.remove}
    for item in args.source:
        name, path = item.split("=", 1)
        texts[name] = open(path).read()
    real = conv_chain._tma_lib()
    with ThreadPoolExecutor(max(1, len(texts))) as pool:
        built = dict(zip(texts, pool.map(lambda kv: _compile(*kv, real, "ocf_conv3x3_tma"),
                                         texts.items())))
    variants = {"tma": real, **built}

    card = gpu_info()
    model, x = make_inputs(BATCH, HEIGHT, WIDTH, torch.bfloat16, "cuda", SEED)
    model.eval()
    with torch.no_grad():
        calls = _groups(model, x)
    result, lib = {}, conv_chain._tma_lib
    try:
        for inputs, group in calls:
            shape = tuple(inputs[0].shape)
            convs = list(_convs(inputs, group))
            if not convs:
                continue
            row = result.setdefault(str(shape), {})
            couts = [group.specs[j].cout for j, _, _ in convs]
            print(f"group {shape}: couts {couts}")
            for name, fn in variants.items():
                conv_chain._tma_lib = lambda fn=fn: fn
                per, host = [], []
                for j, reads, out in convs:
                    segs = conv_chain.merge_segments(reads)
                    ms, us = queued_ms(lambda: conv_chain.launch_tma(  # noqa: B023
                        segs, group.packed[j], group.biases[j], out, group.specs[j],
                        "conv_tma_ablation", group.tma[j]), ITERS)  # noqa: B023
                    per.append(ms)
                    host.append(us)
                row[name] = per
                print(f"  {name:12s} {sum(per):8.4f} ms: " + " ".join(f"{v:.4f}" for v in per)
                      + f" (host us a call {' '.join(f'{u:.0f}' for u in host)}) [{card}]")
            conv_chain._tma_lib = lib
            for name, fn in (("staged", None), ("cudnn", None)):
                per, host = [], []
                for j, reads, out in convs:
                    if name == "staged":
                        run = lambda: conv_chain.launch_conv(  # noqa: E731
                            reads, group.packed[j], group.biases[j], out,  # noqa: B023
                            group.specs[j], "conv_tma_ablation", staged=True)  # noqa: B023
                    else:
                        run = _cudnn(reads, group, j)
                    ms, us = queued_ms(run, ITERS)
                    per.append(ms)
                    host.append(us)
                row[name] = per
                print(f"  {name:12s} {sum(per):8.4f} ms: " + " ".join(f"{v:.4f}" for v in per)
                      + f" (host us a call {' '.join(f'{u:.0f}' for u in host)}) [{card}]")
    finally:
        conv_chain._tma_lib = lib
    for name in [*variants, "staged", "cudnn"]:
        total = sum(sum(v[name]) for v in result.values())
        print(f"all groups {name:12s} {total:8.4f} ms [{card}]")
    return result


if __name__ == "__main__":
    main()
