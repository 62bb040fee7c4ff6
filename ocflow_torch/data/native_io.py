"""The port's host decoders (``_native/decode.cc``), loaded with ctypes:
``.flo``, ``.ppm`` / ``.pgm`` (P5, P6), PNG and baseline JPEG, with no
library linked.

A PNG's chunks are walked here and its IDAT stream inflated with the
standard library's ``zlib``; the C++ side undoes the five row filters (pass
by pass for interlaced, Adam7, images) and normalizes the pixels as libpng
does for the JAX package's decoder (``ocflow_tpu/data/_native/decode.cc``:
palette -> RGB, gray of 1/2/4 bits -> 8 bits, tRNS -> alpha, 16-bit samples
in host order). JPEG frames are decoded whole in C++ with libjpeg's
arithmetic (integer IDCT, fancy upsampling, fixed-point YCbCr -> RGB), as
the JAX package's ``read_gen`` decodes them through imageio and Pillow's
libjpeg-turbo; no EXIF orientation is applied, as there. Baseline only
(SOF0, SOF1, Huffman, 8-bit, gray or three components, 4:4:4 / 4:2:2 /
4:2:0); other JPEGs raise ``ValueError`` naming what they are (ROADMAP A8).
``zlib`` and every ctypes call release the GIL, so the loader's threads
decode in parallel.

The library is compiled with ``g++ -O2 -shared -fPIC`` at first use into
``build/ocflow_torch_native/`` at the repository root, its file name keyed
by a digest of the source and the flags, and moved into place with
``os.replace`` (concurrent processes never load a half-written file). A
failed build raises: there is no pure-Python decoder.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
import time
import zlib
from pathlib import Path

import numpy as np

from ocflow_torch.utils.png import PNG_SIGNATURE

_SRC = Path(__file__).resolve().parent / "_native" / "decode.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ocflow_torch_native"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I32, _I64, _F32, _VP = ctypes.c_int32, ctypes.c_int64, ctypes.c_float, ctypes.c_void_p
_PNG_ARGS = [_U8P, _I64, _I32, _I32, _I32, _I32, _I32, _U8P, _I32, _U8P, _I32]
_SIGNATURES = {
    "flo_probe": [_U8P, _I64, _I32P, _I32P],
    "flo_decode": [_U8P, _I64, _VP],
    "ppm_probe": [_U8P, _I64, _I32P, _I32P, _I32P],
    "ppm_decode": [_U8P, _I64, _VP],
    "ppm_decode_norm_f32": [_U8P, _I64, _VP, _I64, _I32, _I32, _F32, _F32],
    "png_out_channels": [_I32] * 6,
    "png_unfilter": _PNG_ARGS + [_VP],
    "png_decode_norm_f32": _PNG_ARGS + [_VP, _I64, _I32, _I32, _F32, _F32],
    "jpeg_probe": [_U8P, _I64, _I32P, _I32P, _I32P],
    "jpeg_decode": [_U8P, _I64, _VP],
}
_ERRORS = {-2: "bad header", -3: "bad header", -4: "truncated", -5: "bad header",
           -6: "bad palette", -7: "unknown row filter", -8: "pixel data too short",
           -11: "crop larger than the image",
           -20: "not a JPEG",
           -21: "progressive (or differential) JPEG: the port decodes baseline JPEG only "
                "(ROADMAP A8 queues the rest)",
           -22: "arithmetic-coded JPEG: the port decodes Huffman-coded baseline JPEG only "
                "(ROADMAP A8 queues the rest)",
           -23: "lossless or hierarchical JPEG: the port decodes baseline JPEG only "
                "(ROADMAP A8 queues the rest)",
           -24: "JPEG of a sample precision other than 8 bits (12-bit?): the port decodes "
                "8-bit baseline JPEG only (ROADMAP A8 queues the rest)",
           -25: "JPEG of neither 1 nor 3 components (CMYK / YCCK?): the port decodes gray "
                "and three-component JPEG only (ROADMAP A8 queues the rest)",
           -26: "JPEG sampling factors other than 4:4:4, 4:2:2 and 4:2:0 (ROADMAP A8 "
                "queues the rest)",
           -27: "corrupt JPEG data", -28: "truncated JPEG", -29: "JPEG without a frame",
           -30: "JPEG too large for memory"}
JPEG_SIGNATURE = b"\xff\xd8\xff"


def library_path() -> Path:
    digest = hashlib.sha1(_SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libocfio-{digest[:12]}.so"


def build() -> dict:
    """Compile the decoder unless it is built: ``{"path", "seconds",
    "log"}`` (``seconds`` 0 when it was). Raises if ``g++`` fails."""
    out = library_path()
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "log": "cached"}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host decoder build failed (g++ exited {proc.returncode}):\n"
                           f"{proc.stdout}")
    os.replace(tmp, out)
    return {"path": str(out), "seconds": time.perf_counter() - t0, "log": proc.stdout}


def load() -> ctypes.CDLL:
    """The decoder library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(library_path()))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _ptr(buf: bytes):
    return ctypes.cast(ctypes.c_char_p(buf), _U8P)


def _check(rc: int, path, what: str) -> None:
    if rc:
        raise ValueError(f"{path}: {what}: {_ERRORS.get(rc, 'not decodable')} (rc={rc})")


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def decode_flo(buf: bytes, path="") -> np.ndarray:
    """Middlebury ``.flo`` bytes -> ``[H, W, 2]`` float32."""
    lib = load()
    w, h = _I32(), _I32()
    _check(lib.flo_probe(_ptr(buf), len(buf), ctypes.byref(w), ctypes.byref(h)), path, ".flo")
    out = np.empty((h.value, w.value, 2), np.float32)
    _check(lib.flo_decode(_ptr(buf), len(buf), out.ctypes.data), path, ".flo")
    return out


class Png:
    """A PNG's header, palette, tRNS bytes and inflated pixel stream."""

    def __init__(self, buf: bytes, path=""):
        if buf[:8] != PNG_SIGNATURE:
            raise ValueError(f"{path}: not a PNG")
        pos, idat, header = 8, zlib.decompressobj(), None
        self.plte = self.trns = b""
        raw = []
        view = memoryview(buf)
        while pos + 12 <= len(buf):
            (n,) = struct.unpack_from(">I", buf, pos)
            kind = bytes(view[pos + 4:pos + 8])
            body = view[pos + 8:pos + 8 + n]
            (crc,) = struct.unpack_from(">I", buf, pos + 8 + n)
            if pos + 12 + n > len(buf) or crc != zlib.crc32(body, zlib.crc32(kind)):
                raise ValueError(f"{path}: PNG chunk {kind!r} truncated or with a bad CRC")
            if kind == b"IHDR":
                header = struct.unpack(">IIBBBBB", body)
            elif kind == b"PLTE":
                self.plte = bytes(body)
            elif kind == b"tRNS":
                self.trns = bytes(body)
            elif kind == b"IDAT":
                raw.append(idat.decompress(body))
            elif kind == b"IEND":
                break
            pos += 12 + n
        if header is None or not raw:
            raise ValueError(f"{path}: PNG without IHDR or IDAT")
        raw.append(idat.flush())
        self.w, self.h, self.depth, self.color, _, _, self.interlace = header
        if self.interlace not in (0, 1):
            raise ValueError(f"{path}: PNG interlace method {self.interlace}")
        self.raw = b"".join(raw)
        self.channels = load().png_out_channels(self.w, self.h, self.depth, self.color,
                                                len(self.plte) // 3, len(self.trns))
        _check(min(self.channels, 0), path, "PNG")

    def args(self) -> tuple:
        return (_ptr(self.raw), len(self.raw), self.w, self.h, self.depth, self.color,
                self.interlace, _ptr(self.plte), len(self.plte) // 3, _ptr(self.trns),
                len(self.trns))


def decode_png(buf: bytes, path="") -> np.ndarray:
    """PNG bytes -> ``[H, W, C]`` uint8, or uint16 for 16-bit images."""
    png = Png(buf, path)
    dtype = np.uint16 if png.depth == 16 else np.uint8
    out = np.empty((png.h, png.w, png.channels), dtype)
    _check(load().png_unfilter(*png.args(), out.ctypes.data), path, "PNG")
    return out


def decode_jpeg(buf: bytes, path="") -> np.ndarray:
    """Baseline JPEG bytes -> ``[H, W, 3]`` uint8 RGB, or ``[H, W, 1]`` for
    gray; equal to libjpeg-turbo's decode (``JDCT_ISLOW``, fancy
    upsampling). Other JPEGs raise ``ValueError``."""
    lib = load()
    w, h, ch = _I32(), _I32(), _I32()
    _check(lib.jpeg_probe(_ptr(buf), len(buf), ctypes.byref(w), ctypes.byref(h),
                          ctypes.byref(ch)), path, "JPEG")
    out = np.empty((h.value, w.value, ch.value), np.uint8)
    _check(lib.jpeg_decode(_ptr(buf), len(buf), out.ctypes.data), path, "JPEG")
    return out


def decode_ppm(buf: bytes, path="") -> np.ndarray:
    """P5 / P6 bytes (maxval <= 255) -> ``[H, W, 1 or 3]`` uint8."""
    lib = load()
    w, h, ch = _I32(), _I32(), _I32()
    _check(lib.ppm_probe(_ptr(buf), len(buf), ctypes.byref(w), ctypes.byref(h),
                         ctypes.byref(ch)), path, "PPM (P5/P6, maxval <= 255)")
    out = np.empty((h.value, w.value, ch.value), np.uint8)
    _check(lib.ppm_decode(_ptr(buf), len(buf), out.ctypes.data), path, "PPM")
    return out


def read_image(path) -> np.ndarray:
    """PNG, JPEG or P5 / P6 PPM (by signature) -> ``[H, W, C]`` uint8
    (uint16 for 16-bit PNGs). Anything else raises ``ValueError``."""
    buf = _read(path)
    if buf[:8] == PNG_SIGNATURE:
        return decode_png(buf, path)
    if buf[:3] == JPEG_SIGNATURE:
        return decode_jpeg(buf, path)
    if buf[:2] in (b"P5", b"P6"):
        return decode_ppm(buf, path)
    raise ValueError(f"{path}: neither a PNG, a JPEG nor a binary PPM")


def read_pair_norm(path1, path2, th: int, tw: int, scale: float = 1.0 / 127.5,
                   offset: float = -1.0) -> np.ndarray | None:
    """Both frames decoded, centre-cropped to ``(th, tw)`` and mapped to
    ``x * scale + offset`` in float32, channel-interleaved into one ``[th,
    tw, 6]`` array, each frame in one C++ pass (the JAX package's
    ``read_pair_norm``). None when a frame needs the generic path, as there:
    a PNG that is 16-bit, interlaced or has fewer than 3 channels, a P5 PPM,
    a JPEG."""
    lib = load()
    out = np.empty((th, tw, 6), np.float32)
    for i, path in enumerate((path1, path2)):
        buf = _read(path)
        dst = out.ctypes.data + 4 * 3 * i
        if buf[:8] == PNG_SIGNATURE:
            png = Png(buf, path)  # holds the buffers the call reads
            rc = lib.png_decode_norm_f32(*png.args(), dst, 6, th, tw, scale, offset)
        elif buf[:2] == b"P6":
            rc = lib.ppm_decode_norm_f32(_ptr(buf), len(buf), dst, 6, th, tw, scale, offset)
        else:
            return None
        if rc == -10:
            return None
        _check(rc, path, "decode")
    return out
