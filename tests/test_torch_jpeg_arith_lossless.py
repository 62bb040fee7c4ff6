"""Arithmetic-coded and lossless JPEG, and the JPEG frames the JAX reader
refuses: the port's ``read_gen`` against the JAX package's, bit for bit, on
the CPU. Pillow's bundled libjpeg-turbo 3.1.3 carries both decoders, so the
JAX reader decodes these files; ``torch_jpeg_writer`` writes them.

- arithmetic coding (jdarith.c): SOF9 sequential and SOF10 progressive,
  gray and 4:2:0, restart intervals (statistics reset), DAC conditioning
  (L, U, Kx) besides the defaults, incomplete progressive scripts (smoothed);
- lossless (SOF3, jdlossls.c / jddiffct.c): predictors 1-7, point
  transforms 0-7, gray, three and four components, subsampled (box
  upsampling: no fancy upsampling where a block is one sample), one
  interleaved scan or a scan a component, restart intervals of whole MCU
  rows (the predictor restarting at the iMCU row that holds the restart);
- raise in both readers: 12-bit precision (Pillow), hierarchical SOF5-7
  and SOF13-15, arithmetic-coded lossless SOF11 (libjpeg), a lossless
  frame that needs a colour conversion (JFIF or an Adobe transform), a
  lossless restart interval that is not whole MCU rows.
"""

import struct

import numpy as np
import pytest

from ocflow_torch.data import frame_io
from ocflow_tpu.data import frame_io as jframe_io
from test_torch_jpeg_progressive import same_as_jax
from test_torch_ops import share_cores  # noqa: F401  (autouse)
from torch_jpeg_writer import (SIMPLE_PROGRESSION_3, seeded_components, write_jpeg,
                               write_lossless_jpeg)

GRAY_SCRIPT = [((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
               ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0)]


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("factors", ["gray", "420"])
def test_arithmetic_matches_jax(tmp_path, progressive, factors):
    f = [(1, 1)] if factors == "gray" else [(2, 2), (1, 1), (1, 1)]
    rng = np.random.default_rng((1, progressive, len(f)))
    path = tmp_path / "a.jpg"
    script = None
    if progressive:
        script = GRAY_SCRIPT if len(f) == 1 else SIMPLE_PROGRESSION_3
    for h, w in ((1, 1), (8, 8), (16, 16), (17, 33), (37, 53)):
        for restart in (0, 2):
            for dac in (None, (1, 3, 20), (0, 0, 1)):
                comps = seeded_components(rng, w, h, f)
                path.write_bytes(write_jpeg(comps, w, h, script, progressive=progressive,
                                            restart=restart, arithmetic=True, dac=dac))
                same_as_jax(path)


def test_arithmetic_incomplete_scripts_match_jax(tmp_path):
    """Progressive arithmetic files whose scans stop early: block smoothing
    applies to them as to Huffman-coded ones."""
    rng = np.random.default_rng(2)
    path = tmp_path / "s.jpg"
    scripts = [[((0, 1, 2), 0, 0, 0, 0)], [((0, 1, 2), 0, 0, 0, 1)],
               [((0, 1, 2), 0, 0, 0, 0)] + [((c,), 1, 5, 0, 1) for c in range(3)]]
    for h, w in ((16, 16), (24, 16), (37, 53)):
        for script in scripts:
            comps = seeded_components(rng, w, h, [(2, 2), (1, 1), (1, 1)])
            path.write_bytes(write_jpeg(comps, w, h, script, progressive=True, restart=3,
                                        arithmetic=True))
            same_as_jax(path)


LOSSLESS_FACTORS = {"gray": [(1, 1)], "444": [(1, 1)] * 3, "420": [(2, 2), (1, 1), (1, 1)],
                    "mixed": [(1, 2), (2, 1), (1, 1)], "cmyk": [(1, 1)] * 4}


def _planes(rng, f, w, h):
    hmax, vmax = max(a for a, _ in f), max(b for _, b in f)
    base = int(rng.integers(0, 256))
    return [np.clip(base + np.cumsum(rng.integers(-9, 10, (-(-h * fv // vmax),
                                                          -(-w * fh // hmax))), 1), 0, 255)
            for fh, fv in f]


@pytest.mark.parametrize("name", list(LOSSLESS_FACTORS))
def test_lossless_matches_jax(tmp_path, name):
    f = LOSSLESS_FACTORS[name]
    rng = np.random.default_rng((3, len(f), f[0][1]))
    hmax = max(a for a, _ in f)
    path = tmp_path / "l.jpg"
    for h, w in ((1, 1), (7, 13), (23, 31)):
        widths = [-(-w * fh // hmax) for fh, _ in f]
        for predictor in range(1, 8):
            pt = int(rng.integers(0, 8))
            for interleaved in (True, False):
                row = -(-w // hmax) if interleaved else int(np.lcm.reduce(widths))
                for restart in (0, row, 3 * row):
                    planes = _planes(rng, f, w, h)
                    path.write_bytes(write_lossless_jpeg(planes, f, w, h, predictor, pt,
                                                         restart, interleaved))
                    got = same_as_jax(path)
                    if name == "gray":  # lossless up to the point transform
                        assert np.array_equal(got[..., 0], (planes[0] >> pt) << pt)


def _both_raise(path, match):
    with pytest.raises(Exception):
        jframe_io.read_gen(str(path))
    with pytest.raises(ValueError, match=match):
        frame_io.read_gen(str(path))


def test_refused_frames_raise_in_both_readers(tmp_path):
    rng = np.random.default_rng(4)
    path = tmp_path / "r.jpg"
    comps = seeded_components(rng, 16, 16, [(1, 1)] * 3)
    base = write_jpeg(comps, 16, 16)
    # 12-bit: the frame's precision byte
    sof = base.index(b"\xff\xc0")
    path.write_bytes(base[:sof + 4] + bytes([12]) + base[sof + 5:])
    _both_raise(path, "precision")
    for marker in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF):  # hierarchical
        path.write_bytes(write_jpeg(comps, 16, 16, frame_marker=marker))
        _both_raise(path, "hierarchical")
    planes = _planes(rng, [(1, 1)] * 3, 8, 8)
    path.write_bytes(write_lossless_jpeg(planes, [(1, 1)] * 3, 8, 8, frame_marker=0xCB))
    _both_raise(path, "SOF11")
    for kw in ({"jfif": True}, {"adobe": 1}):
        path.write_bytes(write_lossless_jpeg(planes, [(1, 1)] * 3, 8, 8, **kw))
        _both_raise(path, "colour conversion")
    planes4 = _planes(rng, [(1, 1)] * 4, 8, 8)
    path.write_bytes(write_lossless_jpeg(planes4, [(1, 1)] * 4, 8, 8, adobe=2))
    _both_raise(path, "colour conversion")
    path.write_bytes(write_lossless_jpeg(planes, [(1, 1)] * 3, 8, 8, restart=3))
    _both_raise(path, "restart interval")
    # past Pillow's decompression-bomb limit (2 * 89478485 pixels), any format
    path.write_bytes(base[:sof + 5] + struct.pack(">HH", 20000, 20000) + base[sof + 9:])
    _both_raise(path, "decompression-bomb")
    path.write_bytes(b"P6\n20000 20000\n65535\n")
    _both_raise(path, "decompression-bomb")
    # and an Adobe transform 0 lossless frame decodes (RGB, no conversion)
    path.write_bytes(write_lossless_jpeg(planes, [(1, 1)] * 3, 8, 8, adobe=0))
    assert np.array_equal(same_as_jax(path), np.stack(planes, -1))


def test_dnl_marker_is_skipped(tmp_path):
    """libjpeg skips a DNL segment after the first scan (a frame whose
    height is 0 in SOF raises)."""
    rng = np.random.default_rng(5)
    comps = seeded_components(rng, 16, 16, [(1, 1)])
    data = write_jpeg(comps, 16, 16)
    path = tmp_path / "d.jpg"
    path.write_bytes(data[:-2] + b"\xff\xdc" + struct.pack(">HH", 4, 16) + data[-2:])
    same_as_jax(path)
    sof = data.index(b"\xff\xc0")
    path.write_bytes(data[:sof + 5] + b"\x00\x00" + data[sof + 7:])
    _both_raise(path, "JPEG")
