"""Four-component JPEG (CMYK and YCCK): the port's ``read_gen`` against the
JAX package's, bit for bit, on the CPU.

The JAX reader's result is neither RGB nor the raw CMYK: libjpeg's output in
``JCS_CMYK`` (YCCK converted by jdcolor.c's ``ycck_cmyk_convert`` where an
Adobe marker's transform is not 0, the samples as stored otherwise), then
Pillow's "CMYK;I" unpack, which inverts every sample of every four-component
JPEG, then ``read_gen``'s ``[..., :3]``.

- Pillow's CMYK files, baseline and progressive, odd sizes;
- ``torch_jpeg_writer`` files: Adobe transform 0, 1 and 2 and no Adobe
  marker, 4:4:4:4 and subsampled (2x2 Y and K), baseline and progressive;
- three components under every JFIF / Adobe / component-id combination
  (RGB or YCbCr, jdapimin.c's choice);
- the committed 436x1024 CMYK frame against its recorded sha256;
- two components, or five, raise (Pillow refuses them).
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
from test_torch_jpeg_progressive import same_as_jax
from test_torch_ops import share_cores  # noqa: F401  (autouse)
from torch_jpeg_writer import seeded_components, write_jpeg

SIZES = ((1, 1), (2, 3), (7, 9), (8, 8), (9, 17), (16, 16), (17, 33), (37, 53))


@pytest.mark.parametrize("quality", [50, 90])
def test_pillow_cmyk_matches_jax(tmp_path, quality):
    rng = np.random.default_rng((1, quality))
    path = tmp_path / "c.jpg"
    for h, w in SIZES:
        for progressive in (False, True):
            img = _smooth(rng, h, w, 4)
            Image.fromarray(img, "CMYK").save(path, quality=quality, progressive=progressive)
            got = same_as_jax(path)
            assert got.shape == (h, w, 3)


FACTORS = {"4444": [(1, 1)] * 4, "2112": [(2, 2), (1, 1), (1, 1), (2, 2)],
           "2111": [(2, 1), (1, 1), (1, 1), (1, 1)]}


@pytest.mark.parametrize("adobe", [None, 0, 1, 2])
@pytest.mark.parametrize("factors", list(FACTORS))
def test_written_four_component_files_match_jax(tmp_path, adobe, factors):
    """CMYK (Adobe transform 0, or no marker) and YCCK (any other transform)
    under three samplings, sequential and progressive."""
    rng = np.random.default_rng((2, 9 if adobe is None else adobe, len(factors)))
    f = FACTORS[factors]
    path = tmp_path / "k.jpg"
    script = ([((0, 1, 2, 3), 0, 0, 0, 1)] + [((c,), 1, 63, 0, 0) for c in range(4)]
              + [((0, 1, 2, 3), 0, 0, 1, 0)])
    for h, w in ((1, 1), (8, 8), (9, 17), (37, 53)):
        for progressive in (False, True):
            comps = seeded_components(rng, w, h, f)
            path.write_bytes(write_jpeg(comps, w, h, script if progressive else None,
                                        progressive=progressive, adobe=adobe))
            same_as_jax(path)


@pytest.mark.parametrize("adobe", [None, 0, 1])
def test_three_component_colour_markers_match_jax(tmp_path, adobe):
    """jdapimin.c's choice for three components: JFIF -> YCbCr, else an
    Adobe transform (0 RGB, other YCbCr), else ids 'R', 'G', 'B' -> RGB and
    any other ids YCbCr."""
    rng = np.random.default_rng((4, 9 if adobe is None else adobe))
    path = tmp_path / "m.jpg"
    for jfif in (False, True):
        for ids in ((1, 2, 3), (82, 71, 66), (5, 6, 7)):
            comps = seeded_components(rng, 19, 11, [(1, 1)] * 3)
            for c, i in zip(comps, ids):
                c.ident = i
            path.write_bytes(write_jpeg(comps, 19, 11, jfif=jfif, adobe=adobe))
            same_as_jax(path)


def test_committed_cmyk_frame_decodes_to_its_sha256():
    entry = json.load(open(FRAMES_JSON))["cmyk_frame"]
    path = os.path.join(DATA, entry["file"])
    got = same_as_jax(path)
    assert got.shape == (entry["height"], entry["width"], 3)
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["decode_sha256"]
    assert hashlib.sha256(open(path, "rb").read()).hexdigest() == entry["file_sha256"]


def test_two_and_five_components_raise(tmp_path):
    rng = np.random.default_rng(3)
    path = tmp_path / "n.jpg"
    for n in (2, 5):
        comps = seeded_components(rng, 16, 16, [(1, 1)] * n)
        path.write_bytes(write_jpeg(comps, 16, 16))
        with pytest.raises(Exception):
            jframe_io.read_gen(str(path))
        with pytest.raises(ValueError, match="components"):
            frame_io.read_gen(str(path))
