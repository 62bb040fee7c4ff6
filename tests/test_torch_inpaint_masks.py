"""The port's synthetic occlusion masks (``ocflow_torch.data.occlusion``)
against the JAX package's, which draw their strokes with OpenCV, on the CPU.

Bit for bit: ``free_form_occlusion`` and ``static_random_occlusion`` over
hundreds of seeds at 64x128, 384x1024 and 448x1024 and ratios 0.2, 0.4 and
0.5 (the stroke loop stops at a coverage of 0.9 * ratio, so one pixel can
move every later draw); single thick strokes against ``cv2.line`` itself,
with ends inside, on the border and far off the image, widths 5-30;
``apply_occlusion``.
"""

import cv2
import numpy as np
import pytest

from ocflow_torch.data import occlusion as tocc
from ocflow_tpu.data import occlusion as jocc
from test_torch_ops import share_cores  # noqa: F401  (autouse)

RATIOS = (0.2, 0.4, 0.5)
# (height, width, seeds per ratio): the test size and the inpainting datasets' sizes
SIZES = ((64, 128, 150), (384, 1024, 12), (448, 1024, 12))


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("h, w, seeds", SIZES)
def test_free_form_occlusion_equals_jax_bit_for_bit(h, w, seeds, ratio):
    for seed in range(seeds):
        want = jocc.free_form_occlusion(np.random.default_rng((seed, h)), h, w, ratio)
        got = tocc.free_form_occlusion(np.random.default_rng((seed, h)), h, w, ratio)
        assert _same(got, want), (seed, h, w, ratio, int((got != want).sum()))


@pytest.mark.parametrize("ratio", RATIOS)
def test_static_random_occlusion_equals_jax_bit_for_bit(ratio):
    for seed in range(200):
        for h, w, _ in SIZES:
            want = jocc.static_random_occlusion(np.random.default_rng(seed), h, w, ratio)
            got = tocc.static_random_occlusion(np.random.default_rng(seed), h, w, ratio)
            assert _same(got, want), (seed, h, w, ratio)


def test_free_form_draws_continue_in_step():
    """The generator is left where the JAX function leaves it (the datasets
    draw nothing after the mask, but a caller may)."""
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    jocc.free_form_occlusion(a, 64, 128, 0.4)
    tocc.free_form_occlusion(b, 64, 128, 0.4)
    assert a.random() == b.random()


def _ends(kind, rng, h, w):
    if kind == "inside":
        return [(int(rng.integers(0, w)), int(rng.integers(0, h))) for _ in range(2)]
    if kind == "border":
        return [(int(rng.choice([-1, 0, w - 1, w, int(rng.integers(0, w))])),
                 int(rng.choice([-1, 0, h - 1, h, int(rng.integers(0, h))]))) for _ in range(2)]
    return [(int(rng.integers(-3 * w, 4 * w)), int(rng.integers(-3 * h, 4 * h)))
            for _ in range(2)]


@pytest.mark.parametrize("kind", ["inside", "border", "far"])
@pytest.mark.parametrize("h, w", [(64, 128), (37, 53), (448, 1024)])
def test_thick_line_equals_cv2_line(kind, h, w):
    """One stroke at a time, every width from 5 to 30, against
    ``cv2.line(mask, p0, p1, 1.0, width)`` on a float64 mask; a point and a
    one-pixel segment too."""
    rng = np.random.default_rng(("inside", "border", "far").index(kind) * 1000 + h)
    for trial in range(400):
        p0, p1 = _ends(kind, rng, h, w)
        if trial % 25 == 0:
            p1 = p0
        elif trial % 25 == 1:
            p1 = (p0[0] + 1, p0[1])
        width = 5 + trial % 26
        want = np.zeros((h, w))
        cv2.line(want, p0, p1, 1.0, width)
        got = np.zeros((h, w))
        tocc.thick_line(got, p0, p1, width)
        assert np.array_equal(got, want), (p0, p1, width, int((got != want).sum()))


def test_apply_occlusion_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.uniform(-1, 1, (64, 128, 3)).astype(np.float32)
    mask = tocc.free_form_occlusion(rng, 64, 128, 0.5)
    assert _same(tocc.apply_occlusion(img, mask), jocc.apply_occlusion(img, mask))
