"""Build ``ocflow_torch/csrc/*.cu`` with ``nvcc`` at first use; load with ctypes.

Each source becomes one shared library with a plain C interface, compiled
for ``sm_90a`` into ``build/ocflow_torch_kernels/`` at the repository root
(the file name carries a hash of the source, so an edited kernel rebuilds).
``build_all`` starts one ``nvcc`` per source, all at once, holding a lock on
the build directory: ranks of one job that start together build each
library once, the others wait and load it. A build failure raises; there is
no fallback.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ocflow_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> loaded library; a loaded .so lives as long as the process
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> tuple[Path, Path]:
    src = _CSRC / f"{name}.cu"
    h = hashlib.sha1(src.read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:12]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in _CSRC.glob("*.cu"))


def _compile(nvcc: str, src: Path, out: Path) -> dict:
    """One nvcc run; ``seconds`` is this source's own compile time."""
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    secs = time.perf_counter() - t0
    if proc.returncode == 0:
        os.replace(tmp, out)
    return {"path": str(out), "seconds": secs, "log": proc.stdout,
            "returncode": proc.returncode}


def build_all(names=None) -> dict[str, dict]:
    """Compile every (or the named) source, one ``nvcc`` each, all started
    together; skip those already built. Returns ``{name: {"path",
    "seconds", "log", "returncode"}}``."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # an flock: released if its holder dies, so a killed build leaves none
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        result, todo = {}, {}
        for name in names:
            src, out = _target(name)
            if out.exists():
                result[name] = {"path": str(out), "seconds": 0.0, "log": "cached",
                                "returncode": 0}
            else:
                todo[name] = (src, out)
        if todo:
            nvcc = _nvcc()
            with ThreadPoolExecutor(len(todo)) as pool:
                futures = {name: pool.submit(_compile, nvcc, src, out)
                           for name, (src, out) in todo.items()}
            result.update((name, f.result()) for name, f in futures.items())
    failures = [f"{name}: nvcc exited {r['returncode']}\n{r['log']}"
                for name, r in result.items() if r["returncode"] != 0]
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return result


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        _, out = _target(name)
        if not out.exists():
            build_all([name])
        lib = ctypes.CDLL(str(out))
        _LIBS[name] = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")
