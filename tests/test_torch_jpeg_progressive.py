"""Progressive JPEG (SOF2, Huffman): the port's ``read_gen`` against the JAX
package's (imageio -> Pillow -> libjpeg-turbo), bit for bit, on the CPU.

- Pillow's progressive files: gray, 4:4:4, 4:2:2, 4:2:0, optimized tables,
  restart intervals, sizes 1x1 to 64x96;
- files from ``torch_jpeg_writer`` with scan scripts Pillow never writes:
  spectral selection only, successive approximation with refinement scans,
  DC scans one component at a time, EOB runs cut by restart intervals of 1
  to 3 MCUs, and incomplete scripts (DC only, DC at Al 1 or 2, AC bands
  that stop at 5 or 9 or at Al 1) whose decode libjpeg-turbo smooths
  (jdcoefct.c's decompress_smooth_data), at widths and heights of 1 to 5
  blocks where its 5x5 window meets the edges;
- the committed progressive frames (``tests/data/jpeg_frames.json``): each
  a progressive re-encode of a committed baseline frame, whose decode has the
  same sha256 as the baseline's;
- bad progression parameters raise, as in libjpeg.
"""

import hashlib
import json
import os

import numpy as np
import pytest
from PIL import Image

from ocflow_torch.data import frame_io
from ocflow_tpu.data import frame_io as jframe_io
from test_torch_jpeg_adam7 import DATA, FRAMES_JSON, _smooth
from test_torch_ops import share_cores  # noqa: F401  (autouse)
from torch_jpeg_writer import SIMPLE_PROGRESSION_3, seeded_components, write_jpeg


def _rng(*key):
    return np.random.default_rng(key)


def same_as_jax(path):
    """The port's decode equals the JAX reader's: dtype, shape, bytes."""
    ref = jframe_io.read_gen(str(path))
    got = frame_io.read_gen(str(path))
    assert got.dtype == ref.dtype == np.uint8 and got.shape == ref.shape, path
    assert got.tobytes() == ref.tobytes(), path
    return got


SIZES = ((1, 1), (2, 3), (7, 9), (8, 8), (9, 17), (16, 16), (17, 33), (37, 53), (64, 96))


@pytest.mark.parametrize("quality", [40, 75, 95])
def test_pillow_progressive_matches_jax(tmp_path, quality):
    rng = _rng(1, quality)
    kinds = [("RGB", 0, {}), ("RGB", 1, {}), ("RGB", 2, {}), ("L", 0, {}),
             ("RGB", 2, {"optimize": True}), ("L", 0, {"optimize": True}),
             ("RGB", 2, {"restart_marker_blocks": 1}), ("RGB", 1, {"restart_marker_rows": 1}),
             ("L", 0, {"restart_marker_blocks": 3}), ("RGB", 0, {"keep_rgb": True})]
    path = tmp_path / "p.jpg"
    for h, w in SIZES:
        for mode, sub, kw in kinds:
            img = _smooth(rng, h, w, 3 if mode == "RGB" else 1)
            im = Image.fromarray(img if mode == "RGB" else img[..., 0], mode)
            im.save(path, quality=quality, subsampling=sub, progressive=True, **kw)
            same_as_jax(path)


SCRIPTS = {
    "simple": SIMPLE_PROGRESSION_3,
    "spectral": [((0, 1, 2), 0, 0, 0, 0)] + [((c,), 1, 5, 0, 0) for c in range(3)]
    + [((c,), 6, 63, 0, 0) for c in range(3)],
    "dc_one_at_a_time": [((c,), 0, 0, 0, 0) for c in range(3)]
    + [((c,), 1, 63, 0, 0) for c in range(3)],
    "refine_twice": [((0, 1, 2), 0, 0, 0, 2), ((0, 1, 2), 0, 0, 2, 1), ((0, 1, 2), 0, 0, 1, 0)]
    + [((c,), 1, 63, 0, 3) for c in range(3)] + [((c,), 1, 63, 3, 2) for c in range(3)]
    + [((c,), 1, 63, 2, 1) for c in range(3)] + [((c,), 1, 63, 1, 0) for c in range(3)],
    # incomplete: libjpeg smooths these
    "dc_only": [((0, 1, 2), 0, 0, 0, 0)],
    "dc_only_al1": [((0, 1, 2), 0, 0, 0, 1)],
    "dc_one_at_a_time_only": [((c,), 0, 0, 0, 0) for c in range(3)],
    "ac_to_5_al1": [((0, 1, 2), 0, 0, 0, 0)] + [((c,), 1, 5, 0, 1) for c in range(3)],
    "ac_to_2": [((0, 1, 2), 0, 0, 0, 0)] + [((c,), 1, 2, 0, 0) for c in range(3)],
    "refine_stops_at_al1": [((0, 1, 2), 0, 0, 0, 1)] + [((c,), 1, 63, 0, 2) for c in range(3)]
    + [((c,), 1, 63, 2, 1) for c in range(3)] + [((0, 1, 2), 0, 0, 1, 0)],
    "simple_first_four": SIMPLE_PROGRESSION_3[:4],
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_written_scan_scripts_match_jax(tmp_path, name):
    """4:2:0 files, each script at every size and restart interval (EOB runs
    reset at each restart marker)."""
    rng = _rng(2, len(name))
    path = tmp_path / "w.jpg"
    for h, w in ((8, 8), (16, 16), (24, 16), (17, 33), (37, 53), (9, 121)):
        for restart in (0, 1, 3):
            comps = seeded_components(rng, w, h, [(2, 2), (1, 1), (1, 1)])
            path.write_bytes(write_jpeg(comps, w, h, SCRIPTS[name], progressive=True,
                                        restart=restart))
            same_as_jax(path)


GRAY_SCRIPTS = [
    [((0,), 0, 0, 0, 2)],
    [((0,), 0, 0, 0, 0), ((0,), 1, 9, 0, 1)],
    [((0,), 0, 0, 0, 0), ((0,), 1, 9, 0, 0)],
    [((0,), 0, 0, 0, 0), ((0,), 40, 63, 0, 0)],
    [((0,), 0, 0, 0, 1), ((0,), 1, 63, 0, 1), ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0)],
]


@pytest.mark.parametrize("h,w", [(1, 1), (5, 9), (8, 16), (16, 16), (24, 16), (17, 40),
                                 (40, 24), (64, 8)])
def test_gray_smoothing_at_the_edges_matches_jax(tmp_path, h, w):
    """Gray files 1 to 8 blocks wide and high: the smoothing window's
    columns and rows past the edges, and long EOB runs (the band 40-63 is
    mostly zeros) across restart intervals of one block."""
    rng = _rng(3, h, w)
    path = tmp_path / "g.jpg"
    for script in GRAY_SCRIPTS:
        for restart in (0, 1):
            comps = seeded_components(rng, w, h, [(1, 1)])
            path.write_bytes(write_jpeg(comps, w, h, script, progressive=True, restart=restart))
            same_as_jax(path)


def test_bad_progression_raises(tmp_path):
    """Ss > Se, an interleaved AC scan, Al != Ah - 1: libjpeg refuses them,
    and the port raises."""
    rng = _rng(4)
    path = tmp_path / "b.jpg"
    for script in ([((0, 1, 2), 0, 0, 0, 0), ((0, 1), 1, 5, 0, 0)],
                   [((0, 1, 2), 0, 0, 0, 0), ((0,), 6, 5, 0, 0)],
                   [((0, 1, 2), 0, 0, 0, 2), ((0, 1, 2), 0, 0, 2, 0)]):
        comps = seeded_components(rng, 24, 16, [(1, 1)] * 3)
        path.write_bytes(write_jpeg(comps, 24, 16, script, progressive=True))
        with pytest.raises(Exception):
            jframe_io.read_gen(str(path))
        with pytest.raises(ValueError, match="JPEG"):
            frame_io.read_gen(str(path))


def test_committed_progressive_frames_decode_to_the_baseline_sha256():
    """The progressive copies of the committed frames (Pillow, quality 90,
    4:2:0): every coefficient is sent, so each decodes to its baseline
    frame's pixels, and both readers give the recorded sha256."""
    meta = json.load(open(FRAMES_JSON))
    base = {e["file"]: e for e in meta["frames"]}
    prog = meta["progressive_frames"]
    assert len(prog) == 3
    for entry in prog:
        path = os.path.join(DATA, entry["file"])
        got = same_as_jax(path)
        assert hashlib.sha256(got.tobytes()).hexdigest() == entry["decode_sha256"]
        assert entry["decode_sha256"] == base[entry["baseline"]]["decode_sha256"]
        assert hashlib.sha256(open(path, "rb").read()).hexdigest() == entry["file_sha256"]
