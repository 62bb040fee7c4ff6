"""int8 and bf16 GEMM probe on the card (port of ``tools/spike_int8.py``).

Checks the hand-written tensor-core GEMM (``kernels.gemm``,
``csrc/gemm_probe.cu``) against its plain version at 2048^3 (int8 -> int32
exactly, bf16 -> fp32 within 1e-2 of max|plain|), then times it beside the
library GEMMs (``torch._int_mm``, ``torch.matmul``; yardsticks only) with
CUDA events. Prints, per dtype, ms per GEMM and TOP/s of the kernel and of
the library call beside the card's name and power limit, then one JSON
line.

Usage: ``python -m ocflow_torch.tools.spike_int8``.
"""

from __future__ import annotations

import json

import torch

from ocflow_torch import resolve_device
from ocflow_torch.bench import cuda_ms, gpu_info
from ocflow_torch.kernels.gemm import gemm, gemm_plain

SIZE, ITERS = 2048, 50                          # the TPU probe's shape
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM
PEAK_OPS = {torch.int8: 1979e12, torch.bfloat16: 989e12}  # dense tensor cores
BF16_REL_TOL = 1e-2  # fp32 sums of bf16 products in another order
LIBRARY = {torch.int8: torch._int_mm, torch.bfloat16: torch.matmul}


def operands(n: int, dtype: torch.dtype, device, seed: int = 0):
    """Two ``[n, n]`` matrices from ``seed``: int8 codes uniform in
    [-127, 127], or bf16 standard normal."""
    gen = torch.Generator().manual_seed(seed)
    if dtype == torch.int8:
        a, b = (torch.randint(-127, 128, (n, n), generator=gen, dtype=torch.int8)
                for _ in range(2))
    else:
        a, b = (torch.randn((n, n), generator=gen).to(dtype) for _ in range(2))
    return a.to(device), b.to(device)


def bound_ms(m: int, n: int, k: int, dtype: torch.dtype) -> tuple[float, str]:
    """The least time of ``[m, k] @ [k, n]`` on the card and what sets it:
    operands read once and the 4-byte output written once at the HBM rate,
    or ``2mnk`` operations at the dense tensor-core peak."""
    item = torch.tensor([], dtype=dtype).element_size()
    b_ms = ((m * k + k * n) * item + m * n * 4) / HBM_BYTES_PER_S * 1e3
    o_ms = 2 * m * n * k / PEAK_OPS[dtype] * 1e3
    return max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations"


def probe(device=None) -> dict:
    """Check and time the GEMM kernel at ``SIZE``^3 in int8 and bf16.
    Returns ``{"int8" | "bfloat16": {"ms", "library_ms", "plain_ms",
    "bound_ms", "bound_by", "max_abs_err", "tops", "library_tops"}}``;
    raises if the kernel disagrees with its plain version."""
    dev = resolve_device(device)
    out = {}
    for dtype in (torch.int8, torch.bfloat16):
        a, b = operands(SIZE, dtype, dev)
        got = gemm(a, b)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        ref = gemm_plain(a, b)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        err = (got.double() - ref.double()).abs().max().item()
        if dtype == torch.int8:
            if not torch.equal(got, ref):
                raise AssertionError(f"int8 gemm differs from its plain version: {err}")
        elif not err <= BF16_REL_TOL * ref.abs().max().item():
            raise AssertionError(f"bf16 gemm: {err} > {BF16_REL_TOL} of max|plain|")
        ms = cuda_ms(lambda: gemm(a, b), ITERS)
        lib_ms = cuda_ms(lambda: LIBRARY[dtype](a, b), ITERS)
        bound, by = bound_ms(SIZE, SIZE, SIZE, dtype)
        ops = 2 * SIZE ** 3
        out[str(dtype)[6:]] = {
            "ms": ms, "library_ms": lib_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "max_abs_err": err,
            "tops": ops / ms / 1e9, "library_tops": ops / lib_ms / 1e9}
    return out


def main() -> dict:
    res = probe()
    card = gpu_info()
    for name, r in res.items():
        print(f"{name} {SIZE}^3: kernel {r['ms']:.4f} ms ({r['tops']:.1f} TOP/s), "
              f"library {r['library_ms']:.4f} ms ({r['library_tops']:.1f} TOP/s), "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), max_abs_err "
              f"{r['max_abs_err']:.3e} [{card}]")
    print(json.dumps({"size": SIZE, "device": card, **res}))
    return res


if __name__ == "__main__":
    main()
