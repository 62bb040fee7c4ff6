"""JPEG sampling factors past 4:4:4 / 4:2:2 / 4:2:0: the port's ``read_gen``
against the JAX package's, bit for bit, on the CPU.

libjpeg-turbo 3.1.3's jdsample.c picks each component's upsampler from its
ratio to the largest factors: fancy h2v1 and h2v2 (plain where the
component is at most 2 samples wide), fancy h1v2 (4:4:0), and box
replication (``int_upsample``) for every other integral ratio; a ratio that
is not an integer raises, and so does an interleaved scan of more than 10
blocks an MCU (jdinput.c).

- OpenCV's writer: 4:1:1, 4:2:0, 4:2:2, 4:4:0, 4:4:4, baseline and
  progressive;
- ``torch_jpeg_writer`` files: 4:4:0, 4:1:1, 4:1:0, ratios of 3, factors up
  to 4x4 (scans one component at a time), chroma sampled finer than luma,
  mixed h / v ratios, at widths of 1 to 70 pixels (chroma 1 or 2 samples
  wide included), baseline and progressive.
"""

import cv2
import numpy as np
import pytest

from ocflow_torch.data import frame_io
from ocflow_tpu.data import frame_io as jframe_io
from test_torch_jpeg_adam7 import _smooth
from test_torch_jpeg_progressive import same_as_jax
from test_torch_ops import share_cores  # noqa: F401  (autouse)
from torch_jpeg_writer import seeded_components, write_jpeg

SIZES = ((1, 1), (3, 5), (8, 8), (9, 17), (17, 33), (37, 53), (33, 70))


@pytest.mark.parametrize("factor", ["411", "420", "422", "440", "444"])
def test_opencv_samplings_match_jax(tmp_path, factor):
    flag = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{factor}")
    rng = np.random.default_rng((1, int(factor)))
    path = str(tmp_path / "s.jpg")
    for h, w in SIZES:
        img = _smooth(rng, h, w, 3)
        for progressive in (0, 1):
            assert cv2.imwrite(path, img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag,
                                           cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
                                           cv2.IMWRITE_JPEG_QUALITY, 80])
            same_as_jax(path)


FACTORS = {
    "440": [(1, 2), (1, 1), (1, 1)], "411": [(4, 1), (1, 1), (1, 1)],
    "410": [(4, 2), (1, 1), (1, 1)], "h3": [(3, 1), (1, 1), (1, 1)],
    "v3": [(1, 3), (1, 1), (1, 1)], "4x4": [(4, 4), (1, 1), (1, 1)],
    "chroma_finer": [(1, 1), (2, 2), (2, 2)], "chroma_wider": [(1, 1), (2, 1), (1, 1)],
    "mixed": [(2, 1), (1, 2), (1, 1)], "h2v4": [(2, 4), (1, 2), (1, 1)],
    "h4v2": [(4, 2), (2, 1), (1, 1)], "h4v4_h2v2": [(4, 4), (2, 2), (1, 1)],
}


@pytest.mark.parametrize("name", list(FACTORS))
def test_written_samplings_match_jax(tmp_path, name):
    f = FACTORS[name]
    rng = np.random.default_rng((2, len(name), f[0][0], f[0][1]))
    interleaved = sum(h * v for h, v in f) <= 10
    path = tmp_path / "w.jpg"
    for h, w in SIZES:
        for progressive in (False, True):
            if progressive:
                script = [((0, 1, 2) if interleaved else (c,), 0, 0, 0, 0)
                          for c in range(1 if interleaved else 3)]
                script += [((c,), 1, 63, 0, 0) for c in range(3)]
            else:
                script = None if interleaved else [((c,), 0, 63, 0, 0) for c in range(3)]
            comps = seeded_components(rng, w, h, f)
            path.write_bytes(write_jpeg(comps, w, h, script, progressive=progressive,
                                        restart=2 if w == 53 else 0))
            same_as_jax(path)


def test_unsupported_samplings_raise(tmp_path):
    """A ratio that is not an integer (3:2, 4:3), and an interleaved scan of
    18 blocks an MCU: libjpeg refuses both, and so does the port."""
    rng = np.random.default_rng(3)
    path = tmp_path / "f.jpg"
    cases = [([(3, 2), (2, 1), (1, 1)], "not an integer"),
             ([(4, 1), (3, 1), (1, 1)], "not an integer"),
             ([(4, 4), (1, 1), (1, 1)], "10 blocks")]
    for f, match in cases:
        comps = seeded_components(rng, 20, 20, f)
        path.write_bytes(write_jpeg(comps, 20, 20))
        with pytest.raises(Exception):
            jframe_io.read_gen(str(path))
        with pytest.raises(ValueError, match=match):
            frame_io.read_gen(str(path))
