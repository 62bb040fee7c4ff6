"""Fuzz the port's host decoders (``ocflow_torch/data/_native/decode.cc``)
under AddressSanitizer and UndefinedBehaviorSanitizer.

    PYTHONPATH=. python tests/fuzz_decode.py --out DIR [--n 6000] [--seed 0] [--src FILE]

Seed files are written with ``torch_jpeg_writer`` and by hand: sequential,
progressive (complete and incomplete scripts, restarts), arithmetic-coded,
lossless, four-component and oddly sampled JPEGs, and every kind of PNM
(binary 8- and 16-bit, ASCII, bitmaps, ``Pf``). Each mutant flips, inserts,
deletes or overwrites random bytes, or truncates the file. A C++ driver,
compiled with ``-fsanitize=address,undefined`` from ``decode.cc`` alone,
probes and decodes every mutant the way ``native_io`` does (the JPEG and PNM
entry points); a sanitizer report or a crash fails the run. Frames that a
probe sizes past 4M pixels are skipped (the Python side refuses past
Pillow's 178,956,970). Prints one JSON line: the mutants, their return
codes, and the crashes (0 expected).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_jpeg_writer import (SIMPLE_PROGRESSION_3, seeded_components, write_jpeg,  # noqa: E402
                               write_lossless_jpeg)

SRC = Path(__file__).resolve().parents[1] / "ocflow_torch" / "data" / "_native" / "decode.cc"
BATCH = 200  # mutants a driver process

DRIVER = r"""
#include <cstdint>
#include <cstdio>
#include <vector>
extern "C" {
int jpeg_probe(const uint8_t*, int64_t, int32_t*, int32_t*, int32_t*);
int jpeg_decode(const uint8_t*, int64_t, uint8_t*);
int pnm_probe(const uint8_t*, int64_t, int32_t*, int32_t*, int32_t*, int32_t*);
int pnm_decode(const uint8_t*, int64_t, void*);
int ppm_probe(const uint8_t*, int64_t, int32_t*, int32_t*, int32_t*);
int ppm_decode(const uint8_t*, int64_t, void*);
}
int main(int argc, char** argv) {
  for (int i = 1; i < argc; i++) {
    FILE* f = fopen(argv[i], "rb");
    if (!f) return 2;
    std::vector<uint8_t> buf;
    int c;
    while ((c = fgetc(f)) != EOF) buf.push_back((uint8_t)c);
    fclose(f);
    const int64_t n = (int64_t)buf.size();
    int32_t w = 0, h = 0, ch = 0, type = 0;
    int rc;
    if (n >= 3 && buf[0] == 0xFF && buf[1] == 0xD8) {
      rc = jpeg_probe(buf.data(), n, &w, &h, &ch);
      if (!rc && (int64_t)w * h <= (4 << 20)) {
        std::vector<uint8_t> out((size_t)w * h * ch);
        rc = jpeg_decode(buf.data(), n, out.data());
      } else if (!rc) {
        rc = 1;  // skipped
      }
    } else {
      rc = ppm_probe(buf.data(), n, &w, &h, &ch);
      if (!rc && (int64_t)w * h <= (4 << 20)) {
        std::vector<uint8_t> out((size_t)w * h * ch + 1);
        rc = ppm_decode(buf.data(), n, out.data());
      } else {
        rc = pnm_probe(buf.data(), n, &w, &h, &ch, &type);
        if (!rc && (int64_t)w * h <= (4 << 20)) {
          std::vector<uint8_t> out((size_t)w * h * ch * 4 + 4);
          rc = pnm_decode(buf.data(), n, out.data());
        } else if (!rc) {
          rc = 1;
        }
      }
    }
    printf("%d\n", rc);
    fflush(stdout);  // a crash keeps the codes of the files before it
  }
  return 0;
}
"""


def seeds(rng) -> dict[str, bytes]:
    out = {}
    f3 = [(2, 2), (1, 1), (1, 1)]
    for h, w in ((8, 8), (17, 33), (37, 53)):
        tag = f"{h}x{w}"
        out[f"seq_{tag}"] = write_jpeg(seeded_components(rng, w, h, f3), w, h, restart=2)
        out[f"prog_{tag}"] = write_jpeg(seeded_components(rng, w, h, f3), w, h,
                                        SIMPLE_PROGRESSION_3, progressive=True, restart=1)
        out[f"prog_incomplete_{tag}"] = write_jpeg(
            seeded_components(rng, w, h, f3), w, h,
            [((0, 1, 2), 0, 0, 0, 1)] + [((c,), 1, 5, 0, 1) for c in range(3)],
            progressive=True)
        out[f"arith_{tag}"] = write_jpeg(seeded_components(rng, w, h, f3), w, h,
                                         restart=3, arithmetic=True, dac=(1, 3, 20))
        out[f"arith_prog_{tag}"] = write_jpeg(seeded_components(rng, w, h, f3), w, h,
                                              SIMPLE_PROGRESSION_3, progressive=True,
                                              arithmetic=True)
        out[f"cmyk_{tag}"] = write_jpeg(seeded_components(rng, w, h, [(2, 2), (1, 1), (1, 1),
                                                                      (2, 2)]), w, h, adobe=2)
        out[f"sampling_{tag}"] = write_jpeg(seeded_components(rng, w, h, [(4, 1), (1, 2),
                                                                          (1, 1)]), w, h)
        planes = [rng.integers(0, 256, (-(-h * v // 2), -(-w * u // 2))) for u, v in f3]
        out[f"lossless_{tag}"] = write_lossless_jpeg(planes, f3, w, h, 4, 1, -(-w // 2))
    img = rng.integers(0, 65536, (9, 11, 3))
    out["p6_16"] = b"P6\n11 9\n65535\n" + img.astype(">u2").tobytes()
    out["p5_1000"] = b"P5\n11 9\n1000\n" + (img[..., 0] % 1001).astype(">u2").tobytes()
    out["p3"] = b"P3\n11 9\n#c\n1000\n" + " ".join(str(v % 1001) for v in img.ravel()).encode()
    out["p2"] = b"P2 11 9 255 " + " ".join(str(v % 256) for v in img[..., 0].ravel()).encode()
    out["p1"] = b"P1\n11 9\n" + "".join(str(v % 2) for v in img[..., 0].ravel()).encode()
    out["p4"] = b"P4\n11 9\n" + rng.integers(0, 256, 18, dtype=np.uint8).tobytes()
    out["pf"] = b"Pf\n11 9\n-1.0\n" + rng.normal(size=99).astype("<f4").tobytes()
    return out


def mutate(rng, data: bytes) -> bytes:
    b = bytearray(data)
    for _ in range(int(rng.integers(1, 6))):
        kind = int(rng.integers(0, 5))
        pos = int(rng.integers(0, max(1, len(b))))
        if kind == 0 and b:    # flip bits
            b[pos % len(b)] ^= 1 << int(rng.integers(0, 8))
        elif kind == 1 and b:  # overwrite with a byte a decoder cares about
            b[pos % len(b)] = int(rng.choice([0, 0xFF, 0xD0, 0xDA, 0xC4, 0x7F, 0x80,
                                              int(rng.integers(0, 256))]))
        elif kind == 2:        # insert
            b[pos:pos] = rng.integers(0, 256, int(rng.integers(1, 9)), dtype=np.uint8).tobytes()
        elif kind == 3 and b:  # delete
            del b[pos:pos + int(rng.integers(1, 9))]
        else:                  # truncate
            del b[pos:]
    return bytes(b)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=6000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--src", default=str(SRC), help="the decoder source to build")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "driver.cc").write_text(DRIVER)
    exe = out / "fuzz_driver"
    subprocess.run(["g++", "-O1", "-g", "-std=c++17", "-fsanitize=address,undefined",
                    "-fno-sanitize-recover=undefined", "-o", str(exe), str(out / "driver.cc"),
                    args.src], check=True)
    rng = np.random.default_rng(args.seed)
    base = seeds(rng)
    names = sorted(base)
    env = dict(os.environ, ASAN_OPTIONS="allocator_may_return_null=1:detect_leaks=1",
               UBSAN_OPTIONS="print_stacktrace=1:halt_on_error=1")
    rcs, crashes, done = collections.Counter(), [], 0
    while done < args.n:
        paths = []
        for i in range(min(BATCH, args.n - done)):
            name = names[int(rng.integers(0, len(names)))]
            path = out / f"m_{i}.bin"
            data = base[name] if done + i < len(names) else mutate(rng, base[name])
            path.write_bytes(data)
            paths.append(path)
        proc = subprocess.run([str(exe)] + [str(p) for p in paths], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        got = proc.stdout.split()
        rcs.update(int(r) for r in got)
        if proc.returncode != 0 or len(got) != len(paths):
            bad = paths[len(got)] if len(got) < len(paths) else None
            crashes.append({"file": str(bad), "stderr": proc.stderr[-2000:]})
            if bad is not None:
                keep = out / f"crash_{len(crashes)}.bin"
                keep.write_bytes(bad.read_bytes())
        done += len(paths)
    print(json.dumps({"mutants": done, "seeds": len(names), "crashes": len(crashes),
                      "return_codes": dict(sorted(rcs.items())),
                      "crash_files": [c["file"] for c in crashes][:5]}))
    for c in crashes[:3]:
        print(c["stderr"], file=sys.stderr)
    return 1 if crashes else 0


if __name__ == "__main__":
    sys.exit(main())
