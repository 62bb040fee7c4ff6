"""int8 and bf16 GEMM probe on the card (port of ``tools/spike_int8.py``).

Checks the hand-written tensor-core GEMM (``kernels.gemm``,
``csrc/gemm_probe.cu``) against its plain version at 2048^3 (int8 -> int32
exactly, bf16 -> fp32 within 1e-2 of max|plain|), then times it beside the
library GEMMs (yardsticks only): ``torch._int_mm`` for int8 (int32 out,
the kernel's function) and, for bf16, ``torch.matmul`` (bf16 out, half the
output bytes) and ``torch.mm(..., out_dtype=torch.float32)`` (fp32 out,
the kernel's function).

Timing (``queued_ms``): a spin kernel (``torch.cuda._sleep``) holds the
stream while the host issues 50 calls between two CUDA events, so the
calls are queued before the start event fires and the events time the
card running them back to back, not the host issuing them (a ~20 us
kernel issues in about as long from Python). The spin lasts twice the
measured issue time; if the start event has fired before the last call is
issued, the run is taken again with a longer spin. The host's issue time
per call is reported beside. Operands stay L2-warm between calls, as in
any loop of calls.

Beside them, the time the card takes to write the 16 MB output alone (a
``zero_`` of it, queued the same way): the floor of a GEMM whose stores
all come at its end. The plain version is timed after a warm-up call.

Prints, per dtype, ms per GEMM and TOP/s of the kernel and of the library
call, the host microseconds to issue one kernel call, beside the card's
name and power limit, then one JSON line. ``--sweep`` also times kernel
and library at M = N = 2048 and K = 512, 2048, 8192: the slope over K is
the steady rate of the main loop, the rest what a call costs besides.

Usage: ``python -m ocflow_torch.tools.spike_int8 [--sweep]``. The module
needs only ``kernels.gemm``'s ``gemm`` / ``gemm_plain`` and
``bench.gpu_info``, so a copy of it times another tree's kernel the same
way.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ocflow_torch import resolve_device
from ocflow_torch.bench import gpu_info
from ocflow_torch.kernels.gemm import gemm, gemm_plain

SIZE, ITERS = 2048, 50                          # the TPU probe's shape
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM
PEAK_OPS = {torch.int8: 1979e12, torch.bfloat16: 989e12}  # dense tensor cores
BF16_REL_TOL = 1e-2  # fp32 sums of bf16 products in another order
LIBRARY = {torch.int8: torch._int_mm, torch.bfloat16: torch.matmul}
# the library call of the kernel's own function where LIBRARY's differs
SAME_OUTPUT = {torch.bfloat16: lambda a, b: torch.mm(a, b, out_dtype=torch.float32)}
SPIN_CYCLES_PER_S = 2.0e9  # above the card's clock: a spin of n cycles lasts >= n / 2e9 s
SWEEP_K = (512, 2048, 8192)


def operands(n: int, dtype: torch.dtype, device, seed: int = 0, k: int | None = None):
    """``[n, k]`` and ``[k, n]`` matrices (``k`` defaults to ``n``) from
    ``seed``: int8 codes uniform in [-127, 127], or bf16 standard normal."""
    gen = torch.Generator().manual_seed(seed)
    k = n if k is None else k
    if dtype == torch.int8:
        a, b = (torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)
                for shape in ((n, k), (k, n)))
    else:
        a, b = (torch.randn(shape, generator=gen).to(dtype) for shape in ((n, k), (k, n)))
    return a.to(device), b.to(device)


def bound_ms(m: int, n: int, k: int, dtype: torch.dtype) -> tuple[float, str]:
    """The least time of ``[m, k] @ [k, n]`` on the card and what sets it:
    operands read once and the 4-byte output written once at the HBM rate,
    or ``2mnk`` operations at the dense tensor-core peak."""
    item = torch.tensor([], dtype=dtype).element_size()
    b_ms = ((m * k + k * n) * item + m * n * 4) / HBM_BYTES_PER_S * 1e3
    o_ms = 2 * m * n * k / PEAK_OPS[dtype] * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"


def queued_ms(fn, iters: int = ITERS, tries: int = 4) -> tuple[float, float]:
    """``(device ms per call, host us to issue one call)`` of ``fn`` over
    ``iters`` calls queued behind a spin kernel (module docstring)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    spin_s = 2 * (time.perf_counter() - t0) + 1e-3
    torch.cuda.synchronize()
    for _ in range(tries):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(int(spin_s * SPIN_CYCLES_PER_S))
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        issue_s = time.perf_counter() - t0
        end.record()
        queued = not start.query()  # the spin still held the stream
        end.synchronize()
        if queued:
            return start.elapsed_time(end) / iters, issue_s / iters * 1e6
        spin_s *= 4
    raise RuntimeError(f"queued_ms: the host did not get {iters} calls ahead of the card")


def probe(device=None) -> dict:
    """Check and time the GEMM kernel at ``SIZE``^3 in int8 and bf16.
    Returns ``{"int8" | "bfloat16": {"ms", "library_ms", "plain_ms",
    "bound_ms", "bound_by", "max_abs_err", "tops", "library_tops",
    "host_us", "library_same_output_ms", "store_ms"}}``
    (``library_same_output_ms`` ``None`` for int8); raises if the kernel
    disagrees with its plain version."""
    dev = resolve_device(device)
    out = {}
    for dtype in (torch.int8, torch.bfloat16):
        a, b = operands(SIZE, dtype, dev)
        got = gemm(a, b)
        ref = gemm_plain(a, b)
        plain_ms, _ = queued_ms(lambda: gemm_plain(a, b), 5)  # noqa: B023
        err = (got.double() - ref.double()).abs().max().item()
        if dtype == torch.int8:
            if not torch.equal(got, ref):
                raise AssertionError(f"int8 gemm differs from its plain version: {err}")
        elif not err <= BF16_REL_TOL * ref.abs().max().item():
            raise AssertionError(f"bf16 gemm: {err} > {BF16_REL_TOL} of max|plain|")
        ms, host_us = queued_ms(lambda: gemm(a, b))  # noqa: B023
        lib_ms, _ = queued_ms(lambda: LIBRARY[dtype](a, b))  # noqa: B023
        same = SAME_OUTPUT.get(dtype)
        same_ms = queued_ms(lambda: same(a, b))[0] if same else None  # noqa: B023
        store_ms, _ = queued_ms(got.zero_)
        bound, by = bound_ms(SIZE, SIZE, SIZE, dtype)
        ops = 2 * SIZE ** 3
        out[str(dtype)[6:]] = {
            "ms": ms, "library_ms": lib_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "max_abs_err": err,
            "tops": ops / ms / 1e9, "library_tops": ops / lib_ms / 1e9,
            "host_us": host_us, "library_same_output_ms": same_ms, "store_ms": store_ms}
    return out


def sweep(device=None) -> dict:
    """Kernel and library ms at ``SIZE`` x ``SIZE`` x each of ``SWEEP_K``,
    per dtype: ``{"int8" | "bfloat16": {K: (ms, library_ms)}}``."""
    dev = resolve_device(device)
    out = {}
    for dtype in (torch.int8, torch.bfloat16):
        row = out[str(dtype)[6:]] = {}
        for k in SWEEP_K:
            a, b = operands(SIZE, dtype, dev, k=k)
            row[k] = (queued_ms(lambda: gemm(a, b))[0],  # noqa: B023
                      queued_ms(lambda: LIBRARY[dtype](a, b))[0])  # noqa: B023
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="int8 / bf16 GEMM probe on the card")
    ap.add_argument("--sweep", action="store_true", help="also time K = 512, 2048, 8192")
    args = ap.parse_args(argv)
    res = probe()
    card = gpu_info()
    for name, r in res.items():
        print(f"{name} {SIZE}^3: kernel {r['ms']:.4f} ms ({r['tops']:.1f} TOP/s, "
              f"{100 * r['bound_ms'] / r['ms']:.1f}% of bound), library "
              f"{r['library_ms']:.4f} ms ({r['library_tops']:.1f} TOP/s)"
              + (f", library with the kernel's fp32 output {r['library_same_output_ms']:.4f} ms"
                 if r["library_same_output_ms"] else "") + ", bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
              f"host issue {r['host_us']:.1f} us a call, the output written alone "
              f"{r['store_ms']:.4f} ms, max_abs_err {r['max_abs_err']:.3e} [{card}]")
    if args.sweep:
        res["sweep"] = sweep()
        for name, row in res["sweep"].items():
            print(f"{name} {SIZE}x{SIZE}xK: " + ", ".join(
                f"K={k} kernel {ms:.4f} ms, library {lib:.4f} ms" for k, (ms, lib) in row.items())
                + f" [{card}]")
    print(json.dumps({"size": SIZE, "device": card, **res}))
    return res


if __name__ == "__main__":
    main()
