"""The port's JPEG and interlaced-PNG decoding against the JAX package's
``read_gen`` (libpng for PNGs; imageio -> Pillow -> libjpeg-turbo for
JPEGs), bit for bit, on the CPU.

- Adam7 PNGs from this file's own writer (Pillow writes none): every depth
  the decoder reads (1, 2, 4, 8, 16 bits) and colour type (gray, gray+alpha,
  RGB, RGBA, palette with and without tRNS, tRNS on gray and RGB), sizes 1x1
  to 37x53 (empty passes below 8 pixels), each of the five row filters and
  a per-row mix; the fused ``read_pair_norm`` sends interlaced frames to the
  generic path, as the JAX package's does;
- Pillow JPEGs at quality 50-100, 4:4:4 / 4:2:2 / 4:2:0, gray, odd sizes,
  restart intervals, optimized Huffman tables, Adobe RGB; no EXIF
  orientation applied (the JAX reader applies none);
- ``ImagesFromFolder(iext="jpg")`` samples against the JAX package's;
- the committed 436x1024 frames (``tests/data/jpeg_frames.json``) against
  their recorded sha256;
- a progressive and a CMYK JPEG decode as the JAX reader decodes them, a
  truncated one raises (``test_torch_jpeg_{progressive,cmyk,sampling}.py``
  hold the rest of those formats).

``PYTHONPATH=. python tests/test_torch_jpeg_adam7.py`` writes the committed
frames anew: the baseline ones, their progressive copies and the CMYK frame.
"""

import hashlib
import json
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from ocflow_torch.data import build_dataset, frame_io, native_io
from ocflow_torch.utils import png
from ocflow_tpu.data import datasets as jdatasets
from ocflow_tpu.data import frame_io as jframe_io
from ocflow_tpu.data import native_io as jnative_io
from test_torch_ops import share_cores  # noqa: F401  (autouse)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FRAMES_JSON = os.path.join(DATA, "jpeg_frames.json")
# the committed frames: Sintel's size, Pillow 4:2:0 at quality 90
FRAMES = {"count": 3, "height": 436, "width": 1024, "quality": 90, "subsampling": 2,
          "seed": 17, "shift": (3, -2)}

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))  # x0, y0, dx, dy
SIZES = ((1, 1), (1, 7), (6, 1), (2, 3), (5, 5), (8, 8), (9, 13), (17, 4), (37, 53))
SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _rng(*key):
    return np.random.default_rng(key)


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """``[rows, n]`` samples -> the rows' bytes at ``depth`` bits (MSB
    first, big-endian 16-bit)."""
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(samples.shape[0], -1)
    if depth == 8:
        return samples.astype(np.uint8)
    bits = np.unpackbits(samples.astype(np.uint8)[..., None], axis=-1)[..., 8 - depth:]
    return np.packbits(bits.reshape(samples.shape[0], -1), axis=1)


def adam7_png(samples: np.ndarray, depth: int, color: int, filters, plte=b"",
              trns=b"") -> bytes:
    """An interlaced PNG of ``samples`` (``[H, W, SAMPLES[color]]``, the
    values as stored): each pass filtered with ``filters`` (a type, or a
    generator of per-row types)."""
    h, w, ns = samples.shape
    bpp = max(1, ns * depth // 8)
    raw = b""
    for x0, y0, dx, dy in ADAM7:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack(sub.reshape(sub.shape[0], -1), depth)
        types = filters if isinstance(filters, int) else filters.integers(0, 5, len(rows))
        raw += png.filter_rows(rows, bpp, types).tobytes()
    chunks = png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 1))
    if plte:
        chunks += png._chunk(b"PLTE", plte)
    if trns:
        chunks += png._chunk(b"tRNS", trns)
    return (png.PNG_SIGNATURE + chunks + png._chunk(b"IDAT", zlib.compress(raw))
            + png._chunk(b"IEND", b""))


def _adam7_cases():
    """(name, depth, colour type, tRNS) for every depth and colour type the
    decoder reads."""
    cases = [(f"gray{d}", d, 0, False) for d in (1, 2, 4, 8, 16)]
    cases += [(f"gray{d}_trns", d, 0, True) for d in (2, 8, 16)]
    cases += [(f"{n}{d}", d, c, False) for n, c in (("ga", 4), ("rgb", 2), ("rgba", 6))
              for d in (8, 16)]
    cases += [(f"rgb{d}_trns", d, 2, True) for d in (8, 16)]
    cases += [(f"palette{d}{'_trns' if t else ''}", d, 3, t) for d in (1, 2, 4, 8)
              for t in (False, True)]
    return cases


@pytest.mark.parametrize("name,depth,color,trns", _adam7_cases())
def test_adam7_matches_libpng(tmp_path, name, depth, color, trns):
    rng = _rng(1, depth, color, trns)
    for i, (h, w) in enumerate(SIZES):
        ns = SAMPLES[color]
        top = (1 << depth) if color != 3 else min(1 << depth, 200)
        samples = rng.integers(0, top, (h, w, ns))
        plte = t_bytes = b""
        if color == 3:
            plte = rng.integers(0, 256, 3 * top, dtype=np.uint8).tobytes()
            if trns:
                t_bytes = rng.integers(0, 256, max(1, top // 2), dtype=np.uint8).tobytes()
        elif trns:
            key = samples[0, 0] if color == 0 else samples[h // 2, w // 2]
            t_bytes = b"".join(struct.pack(">H", int(v)) for v in np.atleast_1d(key))
        for f in (i % 5, rng):  # one type on every row, then a per-row mix
            path = str(tmp_path / f"{name}_{h}x{w}.png")
            with open(path, "wb") as fh:
                fh.write(adam7_png(samples, depth, color, f, plte, t_bytes))
            got = native_io.read_image(path)
            ref = jnative_io.read_image(path)  # libpng
            assert got.dtype == ref.dtype and got.shape == ref.shape, (name, h, w)
            assert np.array_equal(got, ref), (name, h, w)
            assert np.array_equal(frame_io.read_gen(path), jframe_io.read_gen(path))


def test_adam7_pair_norm_takes_the_generic_path(tmp_path):
    """Interlaced frames: ``read_pair_norm`` gives None, as the JAX
    package's does, and the dataset's samples equal the JAX package's."""
    rng = _rng(2)
    for i in range(3):
        img = rng.integers(0, 256, (37, 53, 3))
        with open(tmp_path / f"f_{i}.png", "wb") as fh:
            fh.write(adam7_png(img, 8, 2, rng))
    a, b = str(tmp_path / "f_0.png"), str(tmp_path / "f_1.png")
    assert native_io.read_pair_norm(a, b, 32, 48) is None
    assert jnative_io.read_pair_norm(a, b, 32, 48) is None
    ds = build_dataset("ImagesFromFolder", root=str(tmp_path))
    ref = jdatasets.ImagesFromFolder(root=str(tmp_path))
    assert len(ds) == len(ref) == 2
    for k in range(2):
        assert np.array_equal(ds[k]["images"], ref[k]["images"])


def _smooth(rng, h, w, c, noise=12.0):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    planes = []
    for _ in range(c):
        a, b, ph = rng.uniform(0.01, 0.2, 3)
        planes.append(127 + 100 * np.sin(a * xx + b * yy + 10 * ph)
                      + rng.normal(0, noise, (h, w)))
    return np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)


JPEG_SIZES = ((1, 1), (2, 3), (7, 9), (8, 8), (9, 17), (16, 16), (17, 33), (37, 53),
              (64, 96))


@pytest.mark.parametrize("quality", [50, 75, 90, 100])
def test_jpeg_matches_pillow(tmp_path, quality):
    """Every sampling, gray, odd sizes, restart intervals, optimized tables:
    the port's decode equals the JAX ``read_gen``'s bit for bit."""
    rng = _rng(3, quality)
    kinds = [("RGB", 0, {}), ("RGB", 1, {}), ("RGB", 2, {}), ("L", 0, {}),
             ("RGB", 2, {"restart_marker_blocks": 1}), ("RGB", 1, {"restart_marker_rows": 1}),
             ("L", 0, {"restart_marker_blocks": 3})]
    if quality < 100:
        kinds += [("RGB", 2, {"optimize": True}), ("L", 0, {"optimize": True}),
                  ("RGB", 0, {"keep_rgb": True})]
    n = 0
    for h, w in JPEG_SIZES:
        for mode, sub, kw in kinds:
            img = _smooth(rng, h, w, 3 if mode == "RGB" else 1)
            im = Image.fromarray(img if mode == "RGB" else img[..., 0], mode)
            path = str(tmp_path / f"{h}x{w}.jpg")
            im.save(path, quality=quality, subsampling=sub, **kw)
            got = frame_io.read_gen(path)
            ref = jframe_io.read_gen(path)
            assert got.dtype == ref.dtype == np.uint8, (h, w, mode, sub, kw)
            assert got.shape == ref.shape, (h, w, mode, sub, kw)
            assert np.array_equal(got, ref), (h, w, mode, sub, kw)
            n += 1
    assert n == len(JPEG_SIZES) * len(kinds)


def test_jpeg_exif_orientation_is_not_applied(tmp_path):
    img = _smooth(_rng(4), 16, 24, 3)
    exif = Image.Exif()
    exif[0x0112] = 6  # rotate 90 on display
    path = str(tmp_path / "o6.jpeg")
    Image.fromarray(img).save(path, exif=exif.tobytes(), quality=95)
    got = frame_io.read_gen(path)
    assert got.shape == (16, 24, 3)
    assert np.array_equal(got, jframe_io.read_gen(path))


def test_progressive_and_other_jpegs_raise(tmp_path):
    """Progressive and CMYK JPEGs decode as the JAX reader decodes them (the
    port refused both until it read every frame the JAX reader reads); a
    truncated JPEG raises in both."""
    img = _smooth(_rng(5), 24, 40, 3)
    path = str(tmp_path / "p.jpg")
    Image.fromarray(img).save(path, progressive=True)
    got = frame_io.read_gen(path)
    assert got.shape == (24, 40, 3)
    assert got.tobytes() == jframe_io.read_gen(path).tobytes()
    Image.fromarray(np.concatenate([img, img[..., :1]], -1), "CMYK").save(path)
    got = frame_io.read_gen(path)
    assert got.shape == (24, 40, 3)
    assert got.tobytes() == jframe_io.read_gen(path).tobytes()
    Image.fromarray(img).save(path)
    buf = open(path, "rb").read()
    with open(path, "wb") as fh:
        fh.write(buf[:len(buf) // 2])
    with pytest.raises(ValueError, match="truncated JPEG"):
        frame_io.read_gen(path)
    with pytest.raises(OSError):
        jframe_io.read_gen(path)


def test_images_from_folder_jpg_matches_jax(tmp_path):
    rng = _rng(6)
    base = _smooth(rng, 80, 140, 3)
    for i in range(3):
        Image.fromarray(base[i:i + 70, 2 * i:2 * i + 130]).save(
            tmp_path / f"f_{i:02d}.jpg", quality=85, subsampling=2)
    for size in (None, (32, 64)):
        ds = build_dataset("ImagesFromFolder", root=str(tmp_path), iext="jpg", image_size=size)
        ref = jdatasets.ImagesFromFolder(root=str(tmp_path), iext="jpg", image_size=size)
        assert len(ds) == len(ref) == 2
        for k in range(2):
            assert np.array_equal(ds[k]["images"], ref[k]["images"]), (size, k)


def make_frames(root: str, progressive: bool = False) -> list[str]:
    """The committed frames: a seeded smooth texture, each frame shifted
    by ``FRAMES["shift"]`` pixels from the last, saved by Pillow; with
    ``progressive``, the same saved progressive (``frame_prog_*``: Pillow's
    script sends every coefficient, so each decodes to its baseline
    frame's pixels)."""
    f = FRAMES
    rng = np.random.default_rng(f["seed"])
    n, h, w = f["count"], f["height"], f["width"]
    sx, sy = f["shift"]
    pad = max(abs(sx), abs(sy)) * n
    base = _smooth(rng, h + 2 * pad, w + 2 * pad, 3, noise=4.0)
    paths = []
    for i in range(n):
        y, x = pad + i * sy, pad + i * sx
        path = os.path.join(root, f"frame_{'prog_' if progressive else ''}{i:04d}.jpg")
        Image.fromarray(base[y:y + h, x:x + w]).save(
            path, quality=f["quality"], subsampling=f["subsampling"], progressive=progressive)
        paths.append(path)
    return paths


def test_committed_frames_decode_to_their_sha256():
    meta = json.load(open(FRAMES_JSON))
    assert len(meta["frames"]) == FRAMES["count"]
    total = 0
    for entry in meta["frames"]:
        path = os.path.join(DATA, entry["file"])
        total += os.path.getsize(path)
        got = frame_io.read_gen(path)
        ref = jframe_io.read_gen(path)
        assert got.shape == ref.shape == (entry["height"], entry["width"], 3)
        assert hashlib.sha256(got.tobytes()).hexdigest() == entry["decode_sha256"]
        assert hashlib.sha256(ref.tobytes()).hexdigest() == entry["decode_sha256"]
        assert hashlib.sha256(open(path, "rb").read()).hexdigest() == entry["file_sha256"]
    assert total <= 1 << 20


def make_cmyk_frame(root: str) -> str:
    """The first frame's decode as CMYK (255 - RGB, and K half the green),
    saved by Pillow at the frames' quality."""
    rgb = jframe_io.read_gen(os.path.join(root, "frame_0000.jpg")).astype(np.int64)
    cmyk = np.concatenate([255 - rgb, rgb[..., 1:2] // 2], -1).astype(np.uint8)
    path = os.path.join(root, "frame_cmyk_0000.jpg")
    Image.fromarray(cmyk, "CMYK").save(path, quality=FRAMES["quality"])
    return path


def _entry(path, **extra):
    im = jframe_io.read_gen(path)
    return {"file": os.path.basename(path), "height": im.shape[0], "width": im.shape[1],
            **extra, "file_sha256": hashlib.sha256(open(path, "rb").read()).hexdigest(),
            "decode_sha256": hashlib.sha256(im.tobytes()).hexdigest()}


if __name__ == "__main__":
    out = [_entry(p) for p in make_frames(DATA)]
    prog = [_entry(p, baseline=f"frame_{i:04d}.jpg")
            for i, p in enumerate(make_frames(DATA, progressive=True))]
    cmyk = _entry(make_cmyk_frame(DATA))
    with open(FRAMES_JSON, "w") as fh:
        made_by = (f"PYTHONPATH=. python tests/test_torch_jpeg_adam7.py (make_frames: Pillow "
                   f"{Image.__version__}, quality {FRAMES['quality']}, 4:2:0, a seeded smooth "
                   f"texture shifted {FRAMES['shift']} px a frame; progressive_frames: the "
                   "same with progressive=True; cmyk_frame: make_cmyk_frame, the first "
                   "frame's decode as CMYK); decode_sha256: the JAX package's read_gen "
                   "(imageio, libjpeg-turbo) of each file, uint8 [H, W, 3] C order")
        json.dump({"made_by": made_by, "frames": out, "progressive_frames": prog,
                   "cmyk_frame": cmyk}, fh, indent=1)
        fh.write("\n")
    print(json.dumps({"frames": out, "progressive_frames": prog, "cmyk_frame": cmyk},
                     indent=1))
