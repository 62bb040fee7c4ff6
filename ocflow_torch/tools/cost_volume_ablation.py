"""Times the cost-volume kernels on the card at the shapes their paths give
them, as they are and in variants.

Cases: the forward at d=4 on the five FlowNetCV levels (B=8 448x1024, bf16),
at d=10 on the FlowNetC family's call (8x256x56x128, fp32); the backward at
d=4 on the five levels (bf16, one training step's calls) and at d=10 on
8x256x56x128 in fp32 and bf16. The general kernels (``csrc/cost_volume_any.cu``,
every d > 10): d 11, 12, 16 and 20 on 8x64x112x256 and d 12 on
8x256x56x128 (a FlowNetC built with displacement 12), fp32 and bf16,
forward and backward; and at d=10 on 8x256x56x128, fp32 ("general at
d=10"), beside the tuned kernels' own d=10 case, which the wrapper never
sends there; and the five calls of a FlowNetCV built with displacement 12
(its levels at B=8 448x1024, fp32: the supervised step's "level" cases).
Inputs are seeded normal noise.

Variants, each built aside with nvcc under ``build/``:

- ``kernel``: ``csrc/cost_volume.cu``, ``csrc/cost_volume_bwd.cu`` and
  ``csrc/cost_volume_any.cu`` as they are;
- ``--source NAME=DIR``: the three sources (and their headers) from DIR,
  for example an older tree's ``ocflow_torch/csrc``; a d a source is not
  built for is reported as refused;
- ``--config NAME=MACRO:VALUES[;MACRO:VALUES]``: the sources with a
  configuration line replaced, e.g. ``rows=CV_FWD_D10:4,7,16,1,1`` (the
  ``#define`` lines name the template arguments: the forward's one line per
  d, the backward's ``CV_BWD`` one line for every d, the general kernels'
  ``CV_ANY_FWD``, ``CV_ANY_BWD`` and ``CV_ANY_SKIP``).

``--order`` lists the variants in the order they are timed, names may
repeat (``parent,kernel,kernel,parent``); ``--only REGEX`` keeps the cases
whose path matches. Each call is timed with CUDA events over 20 launches
after a warm-up, L2-warm, and checked against the plain version (max-abs
error over max|plain|). Prints each variant's registers, spills and static
shared memory (``-Xptxas -v``), one line per (variant, case) and the sums
per path beside the card's name and power limit, then one JSON line of all
numbers.

Usage: ``python -m ocflow_torch.tools.cost_volume_ablation [--source
NAME=DIR ...] [--config NAME=SPEC ...] [--order A,B,...] [--only REGEX]``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ocflow_torch.bench import cuda_ms, gpu_info
from ocflow_torch.kernels import _build
from ocflow_torch.kernels import cost_volume as cv_mod

ITERS = 20
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
LEVELS = [(8, 196, 7, 16), (8, 128, 14, 32), (8, 96, 28, 64), (8, 64, 56, 128),
          (8, 32, 112, 256)]
FNETC = (8, 256, 56, 128)
LEVEL2 = (8, 64, 112, 256)
GENERAL_D = (11, 12, 16, 20)
_NAMES = {torch.float32: "fp32", torch.bfloat16: "bf16"}
# (path, kind, d, dtype, shape); kinds ending in "_any" run csrc/cost_volume_any.cu
CASES = ([("fwd d=4 bf16", "fwd", 4, torch.bfloat16, s) for s in LEVELS]
         + [("fwd d=10 fp32", "fwd", 10, torch.float32, FNETC)]
         + [("bwd d=4 bf16", "bwd", 4, torch.bfloat16, s) for s in LEVELS]
         + [("bwd d=10 fp32", "bwd", 10, torch.float32, FNETC),
            ("bwd d=10 bf16", "bwd", 10, torch.bfloat16, FNETC)]
         + [(f"{k} d={d} {_NAMES[t]} general", f"{k}_any", d, t, s)
            for s, ds in ((LEVEL2, GENERAL_D), (FNETC, (12,)))
            for d in ds for t in (torch.float32, torch.bfloat16) for k in ("fwd", "bwd")]
         + [(f"{k} d=10 fp32 general", f"{k}_any", 10, torch.float32, FNETC)
            for k in ("fwd", "bwd")]
         + [(f"{k} d=12 fp32 general level", f"{k}_any", 12, torch.float32, s)
            for s in LEVELS for k in ("fwd", "bwd")])
SOURCES = {"fwd": ("cost_volume", "ocf_cost_volume_fwd", 3),
           "bwd": ("cost_volume_bwd", "ocf_cost_volume_bwd", 5),
           "fwd_any": ("cost_volume_any", "ocf_cost_volume_any_fwd", 3),
           "bwd_any": ("cost_volume_any", "ocf_cost_volume_any_bwd", 5)}


def cost(kind, d, dtype, shape):
    """Bytes (inputs read once, outputs written once), operations, and the
    bound in ms (the larger of bytes at 3.35 TB/s and operations at the
    dtype's peak)."""
    b, c, h, w = shape
    k = (2 * d + 1) ** 2
    item = torch.tensor([], dtype=dtype).element_size()
    px = b * h * w
    if kind.startswith("fwd"):
        nbytes, ops = (2 * c + k) * px * item, 2 * k * c * px
    else:
        nbytes, ops = (k + 4 * c) * px * item, 4 * k * c * px
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_FLOPS[dtype] * 1e3
    return nbytes, ops, max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"


def _bind(lib, kind):
    _, symbol, n_ptr = SOURCES[kind]
    fn = getattr(lib, symbol)
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _configured(text: str, spec: str) -> str:
    for item in spec.split(";"):
        macro, values = item.split(":", 1)
        pattern = re.compile(rf"^#define {re.escape(macro)} .*$", re.M)
        if len(pattern.findall(text)) > 1:
            raise ValueError(f"{macro} is defined more than once")
        text = pattern.sub(f"#define {macro} {values.replace(',', ', ')}", text)
    return text


def _variant_dir(name: str, src_dir: Path, spec: str | None) -> Path:
    """A directory holding the variant's two sources and the headers."""
    out = _build.BUILD_DIR / "cv_ablation" / name
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    for p in src_dir.glob("*.cuh"):
        shutil.copy(p, out / p.name)
    for src in {s for s, _, _ in SOURCES.values()}:
        text = (src_dir / f"{src}.cu").read_text()
        if spec:
            text = _configured(text, spec)
        (out / f"{src}.cu").write_text(text)
    return out


def _ptxas(log: str) -> list:
    """Per compiled kernel: (template arguments, registers, spill stores,
    static shared memory bytes) from ``-Xptxas -v``."""
    out = []
    for block in re.split(r"Compiling entry function", log)[1:]:
        name = re.search(r"'(\S+)'", block)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        smem = re.search(r"(\d+) bytes smem", block)
        out.append((re.sub(r"^.*?_(\w{3})_kernelI", r"\1 ", name.group(1) if name else "?")[:64],
                    int(regs.group(1)) if regs else None,
                    int(spill.group(1)) if spill else 0, int(smem.group(1)) if smem else 0))
    return out


def _compile(directory: Path, kinds) -> dict:
    fns, libs = {}, {}
    for kind in kinds:
        src = SOURCES[kind][0]
        if src not in libs:
            lib = directory / f"lib{src}.so"
            proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(directory),
                                   "-o", str(lib), str(directory / f"{src}.cu")],
                                  capture_output=True, text=True)
            if proc.returncode:
                raise RuntimeError(f"{directory}: nvcc exited {proc.returncode}\n"
                                   f"{proc.stdout}{proc.stderr}")
            for entry in _ptxas(proc.stdout + proc.stderr):
                print(f"built {directory.name}/{src}: {entry[0]}: {entry[1]} registers, "
                      f"{entry[2]} B spill stores, {entry[3]} B static smem")
            libs[src] = ctypes.CDLL(str(lib))
        fns[kind] = _bind(libs[src], kind)
    return fns


def _inputs(kind, d, dtype, shape, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    f1, f2 = (torch.randn(*shape, device="cuda", generator=gen).to(dtype) for _ in range(2))
    if kind.startswith("fwd"):
        return (f1, f2)
    b, _, h, w = shape
    g = torch.randn(b, (2 * d + 1) ** 2, h, w, device="cuda", generator=gen).to(dtype)
    return (f1, f2, g)


def _call(fn, kind, d, args):
    """Launch ``fn`` (a variant's C entry point) on ``args``; returns its
    outputs and a thunk that launches it again, or None if it refuses d."""
    f1 = args[0]
    b, c, h, w = f1.shape
    if kind.startswith("fwd"):
        outs = [torch.empty((b, (2 * d + 1) ** 2, h, w), dtype=f1.dtype, device=f1.device)]
    else:
        outs = [torch.empty_like(f1), torch.empty_like(f1)]
    ptrs = [t.data_ptr() for t in (*args, *outs)]
    dtype = 0 if f1.dtype == torch.float32 else 1
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        return fn(dtype, *ptrs, b, c, h, w, d, stream)

    if run() != 0:
        return None, None
    torch.cuda.synchronize()
    return outs, run


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", nargs="*", default=[], metavar="NAME=DIR")
    ap.add_argument("--config", nargs="*", default=[], metavar="NAME=SPEC")
    ap.add_argument("--order", default=None)
    ap.add_argument("--only", default=None, metavar="REGEX")
    args = ap.parse_args(argv)
    dirs = {"kernel": _variant_dir("kernel", _build._CSRC, None)}
    for item in args.source:
        name, path = item.split("=", 1)
        dirs[name] = _variant_dir(name, Path(path), None)
    for item in args.config:
        name, spec = item.split("=", 1)
        dirs[name] = _variant_dir(name, _build._CSRC, spec)
    cases = [c for c in CASES if not args.only or re.search(args.only, c[0])]
    kinds = sorted({c[1] for c in cases})
    with ThreadPoolExecutor(len(dirs)) as pool:
        fns = dict(zip(dirs, pool.map(lambda d: _compile(d, kinds), dirs.values())))
    order = args.order.split(",") if args.order else list(dirs)

    card = gpu_info()
    rows = []
    for n, (path, kind, d, dtype, shape) in enumerate(CASES):
        if (path, kind, d, dtype, shape) not in cases:
            continue
        inputs = _inputs(kind, d, dtype, shape, seed=n)
        fwd = kind.startswith("fwd")
        plain = (cv_mod.cost_volume_plain(*inputs, d) if fwd
                 else cv_mod.cost_volume_backward_plain(*inputs, d))
        plain = [plain] if fwd else list(plain)
        scale = max(p.float().abs().max().item() for p in plain)
        nbytes, ops, bound, by = cost(kind, d, dtype, shape)
        for turn, name in enumerate(order):
            outs, run = _call(fns[name][kind], kind, d, inputs)
            if run is None:
                print(f"{path} {shape} {name}: refused (not built for d={d})")
                rows.append({"path": path, "shape": shape, "variant": name, "turn": turn,
                             "ms": None})
                continue
            err = max((o.float() - p.float()).abs().max().item() for o, p in zip(outs, plain))
            ms = cuda_ms(run, ITERS)
            rows.append({"path": path, "shape": shape, "variant": name, "turn": turn,
                         "ms": ms, "bound_ms": bound, "bound_by": by,
                         "rel_err": err / max(scale, 1e-30)})
            print(f"{path} {shape} {name} (turn {turn}): {ms:.4f} ms, bound {bound:.4f} ms "
                  f"({by}; {nbytes} B, {ops} flop; {100 * bound / ms:.2f}%), max-abs err "
                  f"over max|plain| {err / max(scale, 1e-30):.2e} [{card}]")
        del inputs, plain
        torch.cuda.empty_cache()
    sums = {}
    for r in rows:
        key = (r["path"], r["variant"], r["turn"])
        if r["ms"] is None:
            sums[key] = None
        elif sums.get(key, 0.0) is not None:
            sums[key] = sums.get(key, 0.0) + r["ms"]
    for (path, name, turn), ms in sums.items():
        print(f"sum {path} {name} (turn {turn}): "
              f"{'refused' if ms is None else f'{ms:.4f} ms'} [{card}]")
    result = {"device": card, "rows": rows,
              "sums": [{"path": p, "variant": v, "turn": t, "ms": ms}
                       for (p, v, t), ms in sums.items()]}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
