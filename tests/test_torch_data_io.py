"""The port's file IO and host decoder against the JAX package's (libpng,
OpenCV) and imageio, on the CPU.

- ``.flo``, PFM, PPM (P5, P6) and KITTI's 16-bit flow PNGs: exact, written
  by either package and read by the other;
- the PNG reader (``data.native_io``): exact against imageio and the JAX
  package's libpng decoder on 8-bit gray, gray+alpha, RGB, RGBA, palette
  (with and without tRNS, 1 to 8 bits), gray of 1/2/4 bits, tRNS on gray
  and RGB, 16-bit gray and RGB, written by imageio, OpenCV, PIL and the
  port's writer with each of the five row filters (the corpus is checked to
  hold all five); an interlaced PNG decodes as libpng decodes it, one whose
  stream is too short for its seven passes raises (the Adam7 cases at every
  depth and colour type: ``tests/test_torch_jpeg_adam7.py``);
- ``read_pair_norm`` against the JAX package's within 1e-6 (the same fp32
  ``x * scale + offset``; both None where the generic path takes over);
- the resize (``data.resize``) against ``cv2.resize(INTER_LINEAR)``: uint8
  exact, float32 within 1e-5 max-abs (2-channel flows exact), at integer
  and non-integer ratios;
- ``read_gen`` dispatches as the JAX package's, JPEG included.
"""

import io
import struct
import zlib

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from ocflow_torch.data import flow_io, frame_io, native_io
from ocflow_torch.data.resize import resize_linear
from ocflow_torch.utils import png
from ocflow_tpu.data import datasets as jdatasets
from ocflow_tpu.data import flow_io as jflow_io
from ocflow_tpu.data import frame_io as jframe_io
from ocflow_tpu.data import native_io as jnative_io
from test_torch_jpeg_adam7 import adam7_png
from test_torch_ops import share_cores  # noqa: F401  (autouse)

FLOAT_RESIZE_TOL = 1e-5
PAIR_NORM_TOL = 1e-6


def _rng(*key):
    return np.random.default_rng(key)


def _filter_types(path) -> set:
    """The row filter types a PNG file uses."""
    p = native_io.Png(open(path, "rb").read())
    n = (p.w * {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[p.color] * p.depth + 7) // 8
    return set(np.frombuffer(p.raw, np.uint8)[::n + 1][:p.h].tolist())


def test_flo_round_trips_match_jax(tmp_path):
    flow = _rng(0).standard_normal((17, 23, 2)).astype(np.float32) * 30
    a, b = str(tmp_path / "a.flo"), str(tmp_path / "b.flo")
    flow_io.write_flo(a, flow)
    jflow_io.write_flo(b, flow)
    assert open(a, "rb").read() == open(b, "rb").read()
    for path in (a, b):
        got = flow_io.read_flo(path)
        assert got.dtype == np.float32 and np.array_equal(got, flow)
        assert np.array_equal(got, jflow_io.read_flo(path))


@pytest.mark.parametrize("color,endian", [(True, "<"), (False, ">"), (False, "<")])
def test_read_pfm_matches_jax(tmp_path, color, endian):
    shape = (9, 14, 3) if color else (9, 14)
    data = _rng(1).standard_normal(shape).astype(endian + "f4")
    path = tmp_path / "x.pfm"
    scale = -2.0 if endian == "<" else 2.0
    path.write_bytes(b"PF\n" if color else b"Pf\n")
    with open(path, "ab") as f:
        f.write(f"{shape[1]} {shape[0]}\n{scale}\n".encode())
        f.write(data.tobytes())
    got, s = flow_io.read_pfm(str(path))
    ref, s_ref = jflow_io.read_pfm(str(path))
    assert s == s_ref == 2.0 and np.array_equal(got, ref)
    assert np.array_equal(got, data[::-1])


@pytest.mark.parametrize("filters", [0, 4, "mixed"])
def test_kitti_png_flow_matches_jax(tmp_path, filters):
    """The port's KITTI writer (then re-encoded with the given row filters)
    and OpenCV's, each read by both packages."""
    rng = _rng(2)
    flow = rng.uniform(-300, 300, (20, 31, 2)).astype(np.float32)
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    flow_io.write_kitti_png_flow(a, flow)
    if filters:
        png.write_png(a, native_io.read_image(a),
                      rng.integers(0, 5, 20) if filters == "mixed" else filters)
    jflow_io.write_kitti_png_flow(b, flow)  # OpenCV's writer
    for path in (a, b):
        got = flow_io.read_kitti_png_flow(path)
        ref = jflow_io.read_kitti_png_flow(path)
        assert got.dtype == ref.dtype == np.float64 and np.array_equal(got, ref)
    assert np.array_equal(flow_io.read_kitti_png_flow(a), flow_io.read_kitti_png_flow(b))
    raw = cv2.imread(a, cv2.IMREAD_UNCHANGED)[..., ::-1]
    assert raw.dtype == np.uint16 and np.array_equal(raw[..., 2], np.ones((20, 31)))


def _png_cases(tmp_path):
    """``{name: (path, reference pixels [H, W, C])}`` from four writers."""
    rng = _rng(3)
    h, w = 21, 37
    cases = {}

    def imageio_case(name, img):
        path = str(tmp_path / f"{name}.png")
        imageio.imwrite(path, img)
        cases[name] = (path, img if img.ndim == 3 else img[..., None])

    imageio_case("gray8", rng.integers(0, 256, (h, w), dtype=np.uint8))
    imageio_case("gray_alpha8", rng.integers(0, 256, (h, w, 2), dtype=np.uint8))
    imageio_case("rgb8", rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    imageio_case("rgba8", rng.integers(0, 256, (h, w, 4), dtype=np.uint8))
    imageio_case("gray16", rng.integers(0, 65536, (h, w)).astype(np.uint16))
    # smooth content, so libpng's adaptive filtering picks every filter type
    yy, xx = np.mgrid[0:64, 0:96]
    smooth = np.stack([xx * 2, yy * 3, (xx + yy) % 256], -1).astype(np.uint8)
    imageio_case("rgb8_smooth", smooth)
    rgb16 = rng.integers(0, 65536, (h, w, 3)).astype(np.uint16)
    path = str(tmp_path / "rgb16_cv2.png")
    cv2.imwrite(path, rgb16[..., ::-1])
    cases["rgb16_cv2"] = (path, rgb16)
    path = str(tmp_path / "rgb8_cv2.png")
    cv2.imwrite(path, smooth[..., ::-1])
    cases["rgb8_cv2"] = (path, smooth)
    # palette images (PIL), 8 and 4 bits, with and without tRNS
    for bits, ncol in ((8, 200), (4, 16), (2, 4), (1, 2)):
        idx = rng.integers(0, ncol, (h, w), dtype=np.uint8)
        pal = rng.integers(0, 256, (ncol, 3), dtype=np.uint8)
        for trns in (False, True):
            im = Image.fromarray(idx, "P")
            im.putpalette(pal.ravel().tolist())
            alpha = rng.integers(0, 256, ncol, dtype=np.uint8)
            buf = io.BytesIO()
            kw = {"transparency": bytes(alpha)} if trns else {}
            im.save(buf, "PNG", bits=bits, **kw)
            name = f"palette{bits}{'_trns' if trns else ''}"
            path = str(tmp_path / f"{name}.png")
            open(path, "wb").write(buf.getvalue())
            ref = pal[idx]
            if trns:
                ref = np.concatenate([ref, alpha[idx][..., None]], -1)
            cases[name] = (path, ref)
    # gray of 1 bit (PIL mode "1"), tRNS on gray and RGB
    bw = rng.integers(0, 2, (h, w)).astype(bool)
    path = str(tmp_path / "gray1.png")
    Image.fromarray(bw).save(path)
    cases["gray1"] = (path, (bw * 255).astype(np.uint8)[..., None])
    g = rng.integers(0, 256, (h, w), dtype=np.uint8)
    path = str(tmp_path / "gray8_trns.png")
    Image.fromarray(g, "L").save(path, transparency=int(g[3, 4]))
    cases["gray8_trns"] = (path, np.stack([g, np.where(g == g[3, 4], 0, 255)], -1)
                           .astype(np.uint8))
    rgb = rng.integers(0, 4, (h, w, 3), dtype=np.uint8) * 60
    key = tuple(int(v) for v in rgb[2, 2])
    path = str(tmp_path / "rgb8_trns.png")
    Image.fromarray(rgb, "RGB").save(path, transparency=key)
    cases["rgb8_trns"] = (path, np.concatenate(
        [rgb, np.where((rgb == key).all(-1), 0, 255)[..., None].astype(np.uint8)], -1))
    # gray of 2 and 4 bits, packed by hand (no writer here emits them)
    for bits in (2, 4):
        v = rng.integers(0, 1 << bits, (h, w), dtype=np.uint8)
        packed = np.packbits(np.unpackbits(v[..., None], axis=-1)[..., 8 - bits:]
                             .reshape(h, w * bits), axis=1)
        raw = np.concatenate([np.zeros((h, 1), np.uint8), packed], 1).tobytes()
        path = str(tmp_path / f"gray{bits}.png")
        open(path, "wb").write(
            png.PNG_SIGNATURE + png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bits, 0,
                                                                 0, 0, 0))
            + png._chunk(b"IDAT", zlib.compress(raw)) + png._chunk(b"IEND", b""))
        cases[f"gray{bits}"] = (path, (v * (255 // ((1 << bits) - 1)))[..., None])
    # the port's writer, each filter type on every row, and mixed per row
    for dtype, c in ((np.uint8, 3), (np.uint8, 1), (np.uint16, 3), (np.uint16, 4)):
        img = rng.integers(0, np.iinfo(dtype).max + 1, (h, w, c)).astype(dtype)
        for f in (0, 1, 2, 3, 4, "mixed"):
            name = f"port_{np.dtype(dtype).name}x{c}_f{f}"
            path = str(tmp_path / f"{name}.png")
            png.write_png(path, img, rng.integers(0, 5, h) if f == "mixed" else f)
            cases[name] = (path, img)
    return cases


def test_png_reader_matches_imageio_and_libpng(tmp_path):
    cases = _png_cases(tmp_path)
    used = set()
    for name, (path, ref) in cases.items():
        got = native_io.read_image(path)
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        assert np.array_equal(got, ref), name
        assert np.array_equal(got, jnative_io.read_image(path)), name  # libpng
        if "trns" not in name and not name.startswith(("rgb16", "port_uint16")):
            # imageio (PIL) returns 16-bit RGB(A) as 8-bit, drops tRNS and
            # gives 1-bit gray as bool
            io_ref = np.asarray(imageio.imread(path))
            if io_ref.dtype == bool:
                io_ref = io_ref.astype(np.uint8) * 255
            assert np.array_equal(got, io_ref.reshape(ref.shape)), name
        used |= _filter_types(path)
    assert used == {0, 1, 2, 3, 4}


def test_png_reader_refuses_interlaced_and_corrupt(tmp_path):
    img = _rng(9).integers(0, 256, (4, 4, 3), dtype=np.uint8)
    path = tmp_path / "interlaced.png"
    path.write_bytes(adam7_png(img, 8, 2, 4))
    got = native_io.read_image(str(path))
    assert np.array_equal(got, img) and np.array_equal(got, jnative_io.read_image(str(path)))
    # a non-interlaced stream under an Adam7 header: too short for its passes
    data = bytearray(png.encode_png(img))
    ihdr = 8 + 8
    data[ihdr + 12] = 1  # interlace method: Adam7
    data[ihdr + 13:ihdr + 17] = struct.pack(
        ">I", zlib.crc32(bytes(data[ihdr - 4:ihdr + 13])) & 0xFFFFFFFF)
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="pixel data too short"):
        native_io.read_image(str(path))
    data[ihdr + 5] ^= 1  # a byte of IHDR without its CRC
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        native_io.read_image(str(path))


@pytest.mark.parametrize("magic,c", [(b"P6", 3), (b"P5", 1)])
def test_ppm_matches_jax(tmp_path, magic, c):
    img = _rng(4, c).integers(0, 256, (13, 19, c), dtype=np.uint8)
    path = tmp_path / "x.ppm"
    path.write_bytes(magic + b"\n# a comment\n19 13\n255\n" + img.tobytes())
    got = frame_io.read_gen(str(path))
    assert np.array_equal(got, img) and np.array_equal(got, jframe_io.read_gen(str(path)))


def test_read_pair_norm_matches_jax(tmp_path):
    cases = _png_cases(tmp_path)
    ppm = tmp_path / "x.ppm"
    img = _rng(5).integers(0, 256, (30, 40, 3), dtype=np.uint8)
    ppm.write_bytes(b"P6\n40 30\n255\n" + img.tobytes())
    paths = {k: p for k, (p, _) in cases.items()}
    pairs = [("rgb8", "rgba8"), ("palette8", "palette4_trns"), ("rgb8_cv2", "rgb8_smooth"),
             ("gray8", "rgb8"), ("rgb16_cv2", "rgb8"), ("rgb8", "gray_alpha8")]
    for a, b in pairs:
        h, w = (min(cases[a][1].shape[0], cases[b][1].shape[0]) - 3,
                min(cases[a][1].shape[1], cases[b][1].shape[1]) - 5)
        got = native_io.read_pair_norm(paths[a], paths[b], h, w)
        ref = jnative_io.read_pair_norm(paths[a], paths[b], h, w)
        if ref is None:
            assert got is None, (a, b)
            continue
        assert np.abs(got - ref).max() <= PAIR_NORM_TOL, (a, b)
    got = native_io.read_pair_norm(str(ppm), str(ppm), 17, 32)
    ref = jnative_io.read_pair_norm(str(ppm), str(ppm), 17, 32)
    assert np.abs(got - ref).max() <= PAIR_NORM_TOL


RESIZES = [((384, 1024), (448, 1024)), ((436, 1024), (448, 1024)),
           ((320, 1216), (256, 832)), ((375, 1242), (320, 1216)),
           ((384, 512), (320, 448)), ((384, 1024), (192, 512)), ((64, 128), (32, 64)),
           ((100, 150), (64, 64)), ((64, 128), (37, 53)), ((7, 5), (13, 11))]


@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_matches_opencv(src, dst):
    rng = _rng(6, *src, *dst)
    h, w = dst
    for c in (3, 1):
        img = rng.integers(0, 256, src + (c,), dtype=np.uint8)
        got = jdatasets._resize_img(img, h, w)
        assert np.array_equal(resize_linear(img, h, w), cv2.resize(img, (w, h)))
        from ocflow_torch.data.datasets import _resize_img
        assert np.array_equal(_resize_img(img, h, w), got)
    occ = (rng.uniform(size=src + (1,)) > 0.6).astype(np.float32)
    err = np.abs(resize_linear(occ, h, w) - cv2.resize(occ, (w, h))).max()
    assert err <= FLOAT_RESIZE_TOL, err
    flow = rng.uniform(-40, 40, src + (2,)).astype(np.float32)
    got, ref = flow_io.resize_flow_np(flow, h, w), jflow_io.resize_flow_np(flow, h, w)
    assert got.dtype == ref.dtype == np.float32
    assert np.abs(got - ref).max() <= FLOAT_RESIZE_TOL


def test_read_gen_dispatch(tmp_path):
    img = _rng(7).integers(0, 256, (9, 11, 4), dtype=np.uint8)
    imageio.imwrite(tmp_path / "a.png", img)
    flow = _rng(8).standard_normal((9, 11, 2)).astype(np.float32)
    flow_io.write_flo(str(tmp_path / "a.flo"), flow)
    for name in ("a.png", "a.flo"):
        got = frame_io.read_gen(str(tmp_path / name))
        assert np.array_equal(got, jframe_io.read_gen(str(tmp_path / name)))
    assert frame_io.read_gen(str(tmp_path / "a.png")).shape == (9, 11, 3)
    imageio.imwrite(tmp_path / "a.jpg", img[..., :3])
    got = frame_io.read_gen(str(tmp_path / "a.jpg"))
    assert got.shape == (9, 11, 3)
    assert np.array_equal(got, jframe_io.read_gen(str(tmp_path / "a.jpg")))
    with pytest.raises(ValueError, match="Unsupported"):
        frame_io.read_gen(str(tmp_path / "a.gif"))


def test_decoder_builds_into_the_keyed_build_dir():
    lib = native_io.build()
    assert lib["path"] == str(native_io.library_path())
    assert native_io.library_path().parent.name == "ocflow_torch_native"
    assert native_io.library_path().exists()
