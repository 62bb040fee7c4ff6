"""PNM frames: the port's ``read_gen`` against the JAX package's, bit for bit
(shape, dtype, the bytes), on files this module writes; and the fused pair
path's refusals (ROADMAP C8).

The JAX ``read_gen`` reads a binary P5 / P6 of maxval <= 255 with its own
decoder (the raw bytes) and sends every other PNM to imageio, so to Pillow's
PpmImagePlugin: 16-bit files scaled to uint8 (P6) or kept as int32 (P5),
ASCII P2 / P3 scaled with Python's round half to even, P1 / P4 bitmaps as
bool, ``Pf`` as float32 stored bottom-up. Ties (maxval 2, 510, 1020),
comments inside and between tokens, values past maxval (clipped in binary
files, refused in ASCII ones), truncated data, and ASCII data past Pillow's
1 MiB read blocks are each held here. Where the JAX reader raises, the port
raises ``ValueError``.
"""

import os

import numpy as np
import pytest

from ocflow_torch.data import build_dataset, frame_io, native_io
from ocflow_tpu.data import datasets as jdatasets
from ocflow_tpu.data import frame_io as jframe_io
from ocflow_tpu.data import native_io as jnative_io
from test_torch_ops import share_cores  # noqa: F401  (autouse)


def _rng(*key):
    return np.random.default_rng(key)


def _same(path):
    """The port's decode equals the JAX reader's: dtype, shape, bytes."""
    ref = jframe_io.read_gen(str(path))
    got = frame_io.read_gen(str(path))
    assert got.dtype == ref.dtype and got.shape == ref.shape, (path, got.dtype, ref.dtype)
    assert got.tobytes() == ref.tobytes(), path
    return got


def _both_raise(path):
    with pytest.raises(Exception):
        jframe_io.read_gen(str(path))
    with pytest.raises(ValueError):
        frame_io.read_gen(str(path))


def _ascii(values, per_line=7, comment_every=0):
    out, line = [], []
    for i, v in enumerate(np.ravel(values)):
        line.append(str(int(v)))
        if comment_every and i % comment_every == comment_every - 1:
            line.append("# a comment 123\n")
        if len(line) >= per_line:
            out.append(" ".join(line))
            line = []
    out.append(" ".join(line))
    return ("\n".join(out) + "\n").encode()


BINARY = [  # magic, channels, maxval
    (b"P6", 3, 255), (b"P5", 1, 255), (b"P6", 3, 100), (b"P5", 1, 2), (b"P6", 3, 256),
    (b"P6", 3, 510), (b"P6", 3, 1020), (b"P6", 3, 1023), (b"P6", 3, 65535), (b"P5", 1, 256),
    (b"P5", 1, 510), (b"P5", 1, 4095), (b"P5", 1, 65534), (b"P5", 1, 65535)]


@pytest.mark.parametrize("magic,c,maxval", BINARY)
def test_binary_pnm_matches_jax(tmp_path, magic, c, maxval):
    """Every value 0..maxval (and past it: binary samples clip), at two
    sizes and both extensions."""
    rng = _rng(1, c, maxval)
    dt = ">u1" if maxval < 256 else ">u2"
    top = min(maxval + 3, 255 if maxval < 256 else 65535)
    for h, w in ((1, 1), (13, 19), (40, 57)):
        img = rng.integers(0, top + 1, (h, w, c))
        img.ravel()[: min(img.size, maxval + 1)] = np.arange(min(img.size, maxval + 1))
        for ext in (".ppm", ".pgm"):
            path = tmp_path / f"x{ext}"
            path.write_bytes(magic + b"\n# a comment\n%d %d\n%d\n" % (w, h, maxval)
                             + img.astype(dt).tobytes())
            got = _same(path)
            if maxval <= 255:  # the JAX package's own decoder: the bytes as stored
                assert got.dtype == np.uint8 and np.array_equal(got, img.astype(np.uint8))


@pytest.mark.parametrize("magic,c,maxval", [
    (b"P3", 3, 255), (b"P3", 3, 1000), (b"P3", 3, 2), (b"P3", 3, 65535), (b"P2", 1, 255),
    (b"P2", 1, 2), (b"P2", 1, 100), (b"P2", 1, 510), (b"P2", 1, 1000), (b"P2", 1, 65535)])
def test_ascii_pnm_matches_jax(tmp_path, magic, c, maxval):
    """ASCII samples (every value up to maxval, ties included), one or many
    a line, with comments between them."""
    rng = _rng(2, c, maxval)
    for h, w in ((1, 1), (7, 11), (31, 45)):
        img = rng.integers(0, maxval + 1, (h, w, c))
        img.ravel()[: min(img.size, maxval + 1)] = np.arange(min(img.size, maxval + 1))
        for per_line, every in ((1, 0), (9, 5)):
            path = tmp_path / "x.pgm"
            path.write_bytes(magic + b" %d\n#c\n %d %d\n" % (w, h, maxval)
                             + _ascii(img, per_line, every))
            _same(path)


def test_ascii_pnm_header_and_token_rules(tmp_path):
    img = _rng(3).integers(0, 256, (4, 5, 3))
    body = _ascii(img)
    path = tmp_path / "x.ppm"
    cases = [
        b"P3\n5 4\n255\n" + body,
        b"P3\t5\x0b4\x0c255\r" + body,                   # every whitespace byte
        b"P3 #c\n5#c\r 4 2#c\n55\n" + body,              # a comment joins "2" and "55"
        b"P3\n+5 0_4\n0255\n" + body,                    # Python's int()
        b"P3\n5 4\n255\n1#c\n2 " + body[4:],             # a comment inside a data token
        b"P3\n5 4\n255\n" + body + b"999 garbage",       # trailing bytes never read
        b"P6\x0b5 4\x0b255\n" + img.astype(np.uint8).tobytes(),  # \v: Pillow's header
        b"P1\n5 4\n" + b"".join(b"%d" % b for b in img.ravel()[:20] % 2),
        b"P1\n5 4\n1 0#c\n" + b" ".join(b"%d" % b for b in img.ravel()[:18] % 2),
    ]
    for data in cases:
        path.write_bytes(data)
        _same(path)
    bad = [
        b"P3\n5 4\n255\n" + body.replace(b" ", b" 256 ", 1),   # past maxval
        b"P3\n5 4\n255\n-1 " + body,                           # negative
        b"P3\n5 4\n255\n" + body[:20],                          # short
        b"P3\n5 4\n255\n12345678901 " + body,                   # an 11-byte token
        b"P3\n5 4\n0\n" + body, b"P3\n5 4\n65536\n" + body,     # maxval out of range
        b"P3\n0 4\n255\n", b"P3\n5\n", b"P3\n5 4\n2x\n" + body,
        b"P6\n5 4\n255#c\n" + img.astype(np.uint8).tobytes(),  # data joins maxval
        b"P1\n5 4\n0120" + b"0" * 20,                          # not a bit
        b"P5\n5 4\n65535\n" + b"\x00" * 39,                    # truncated binary
        b"P7\n5 4\n255\n", b"PX\n",
    ]
    for data in bad:
        path.write_bytes(data)
        _both_raise(path)


def test_ascii_pnm_past_pillows_read_blocks(tmp_path):
    """More than 1 MiB of ASCII samples: Pillow reads them in blocks of
    ImageFile.SAFEBLOCK bytes; tokens and comments cross the blocks' ends."""
    rng = _rng(4)
    img = rng.integers(0, 1001, (300, 401, 3))
    path = tmp_path / "big.ppm"
    path.write_bytes(b"P3\n401 300\n1000\n" + _ascii(img, 13, 97))
    assert os.path.getsize(path) > 1 << 20
    _same(path)


@pytest.mark.parametrize("h,w", [(1, 1), (1, 9), (8, 8), (9, 17), (33, 31)])
def test_bitmaps_match_jax(tmp_path, h, w):
    """P4 (rows padded to a byte) and P1 (whitespace optional): bool, true
    where the bit is 0."""
    bits = _rng(5, h, w).integers(0, 2, (h, w))
    packed = np.packbits(bits.astype(np.uint8), axis=1)
    p4 = tmp_path / "x.ppm"
    p4.write_bytes(b"P4\n%d %d\n" % (w, h) + packed.tobytes())
    got = _same(p4)
    assert got.dtype == np.bool_ and np.array_equal(got[..., 0], bits == 0)
    p1 = tmp_path / "y.pgm"
    p1.write_bytes(b"P1\n%d %d\n" % (w, h) + b"\n".join(
        b" ".join(b"%d" % b for b in row) for row in bits))
    assert np.array_equal(_same(p1), got)


@pytest.mark.parametrize("scale", [b"-1.0", b"1.0", b"-2.5e0", b"+0_1.5"])
def test_pf_matches_jax(tmp_path, scale):
    """Grayscale PFM under a ``.ppm`` name: float32, rows bottom-up,
    little-endian when the scale is negative."""
    data = _rng(6).normal(0, 100, (7, 5)).astype(np.float32)
    order = "<f4" if scale.startswith(b"-") else ">f4"
    path = tmp_path / "x.ppm"
    path.write_bytes(b"Pf\n5 7\n" + scale + b"\n" + data[::-1].astype(order).tobytes())
    got = _same(path)
    assert got.dtype == np.float32 and np.array_equal(got[..., 0], data)
    path.write_bytes(b"Pf\n5 7\n0.0\n" + data.tobytes())
    _both_raise(path)


def test_pnm_named_jpg_is_read_as_pillow_reads_it(tmp_path):
    """The JAX ``read_gen`` sends a ``.jpg`` straight to Pillow: a binary P6
    of maxval 100 there is scaled, not read raw."""
    img = _rng(7).integers(0, 101, (6, 9, 3), dtype=np.uint8)
    for ext in (".jpg", ".ppm"):
        path = tmp_path / f"x{ext}"
        path.write_bytes(b"P6\n9 6\n100\n" + img.tobytes())
        got = _same(path)
        assert np.array_equal(got, img) == (ext == ".ppm")


def test_pillows_private_magics_raise(tmp_path):
    """P0CMYK, PyP, PyRGBA, PyCMYK: Pillow's own test formats, which the port
    does not read (ROADMAP A8 queues them)."""
    path = tmp_path / "x.ppm"
    for magic, n in ((b"PyRGBA", 4), (b"P0CMYK", 4), (b"PyCMYK", 4), (b"PyP", 1)):
        path.write_bytes(magic + b"\n2 2\n255\n" + bytes(range(4 * n)))
        with pytest.raises(ValueError, match="private PNM"):
            frame_io.read_gen(str(path))


def test_read_pair_norm_is_none_wherever_the_jax_ones_is(tmp_path):
    """C8: the fused pair path gives None on every frame it cannot decode
    or crop, as the JAX package's does, instead of raising."""
    rng = _rng(8)
    img = rng.integers(0, 256, (30, 40, 3))
    files = {
        "p6": b"P6\n40 30\n255\n" + img.astype(np.uint8).tobytes(),
        "p6_16": b"P6\n40 30\n65535\n" + (img * 257).astype(">u2").tobytes(),
        "p6_ascii": b"P3\n40 30\n255\n" + _ascii(img),
        "p6_short": b"P6\n40 30\n255\n" + img.astype(np.uint8).tobytes()[:100],
        "p5": b"P5\n40 30\n255\n" + img[..., 0].astype(np.uint8).tobytes(),
        "png_crc": b"\x89PNG\r\n\x1a\n" + b"\x00\x00\x00\x0dIHDR" + bytes(17),
    }
    paths = {}
    for name, data in files.items():
        paths[name] = str(tmp_path / f"{name}.ppm")
        with open(paths[name], "wb") as fh:
            fh.write(data)
    for a in files:
        for b in files:
            for th, tw in ((17, 32), (30, 40), (31, 40)):
                ref = jnative_io.read_pair_norm(paths[a], paths[b], th, tw)
                got = native_io.read_pair_norm(paths[a], paths[b], th, tw)
                assert (got is None) == (ref is None), (a, b, th, tw)
                if ref is not None:
                    assert np.array_equal(got, ref), (a, b, th, tw)


def test_flyingchairs_on_16bit_p6_matches_jax(tmp_path):
    """C8's regression: FlyingChairs' layout with 16-bit P6 frames. The
    fused path gives None, the generic path decodes them as Pillow does, and
    every sample equals the JAX dataset's (the parent raised ``decode: bad
    header (rc=-3)`` here)."""
    rng = _rng(9)
    for i in range(3):
        for k in (1, 2):
            img = rng.integers(0, 65536, (70, 90, 3))
            (tmp_path / f"{i:05d}_img{k}.ppm").write_bytes(
                b"P6\n90 70\n65535\n" + img.astype(">u2").tobytes())
        flow = rng.normal(0, 3, (70, 90, 2)).astype(np.float32)
        (tmp_path / f"{i:05d}_flow.flo").write_bytes(
            np.array([202021.25], np.float32).tobytes() + np.array([90, 70], np.int32).tobytes()
            + flow.tobytes())
    for size in (None, (32, 48)):
        ds = build_dataset("FlyingChairs", root=str(tmp_path), image_size=size)
        ref = jdatasets.FlyingChairs(root=str(tmp_path), image_size=size)
        assert len(ds) == len(ref) == 3
        for k in range(3):
            got, want = ds[k], ref[k]
            assert got.keys() == want.keys()
            for key in want:
                assert got[key].dtype == want[key].dtype, key
                assert np.array_equal(got[key], want[key]), (size, k, key)
