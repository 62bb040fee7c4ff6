"""The inpainting losses and image metrics against the JAX package's, on the
CPU, within 1e-6 relative: ``masked_l1_loss``, ``recon_loss`` (with and
without a coarse output), ``psnr`` (``inf`` at a zero MSE), ``ssim`` (the
reference's even 4x4 window, at even and odd sizes, 1 to 3 channels) and
``calculate_psnr`` / ``calculate_ssim``, the means over batches of an
inpainting function."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocflow_torch import losses as tlosses
from ocflow_torch import metrics as tmetrics
from ocflow_tpu import losses as jlosses
from ocflow_tpu import metrics as jmetrics
from test_torch_ops import share_cores  # noqa: F401  (autouse)

REL = 1e-6


def _data(seed, b=2, h=64, w=128, c=3):
    rng = np.random.default_rng(seed)
    img = rng.uniform(-1, 1, (b, h, w, c)).astype(np.float32)
    other = np.clip(img + rng.normal(0, 0.2, img.shape), -1, 1).astype(np.float32)
    mask = (rng.uniform(size=(b, h, w, 1)) > 0.7).astype(np.float32)
    return img, other, mask


def _close(got, want, rel=REL):
    got, want = float(got), float(want)
    assert abs(got - want) <= rel * abs(want), (got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_l1_loss_matches_jax(seed):
    img, other, mask = _data(seed)
    t = [torch.from_numpy(a) for a in (other, img, mask)]
    _close(tlosses.masked_l1_loss(*t),
           jlosses.masked_l1_loss(*(jnp.asarray(a) for a in (other, img, mask))))
    # an empty hole: the 1e-16 keeps it finite, 0
    zero = np.zeros_like(mask)
    assert float(tlosses.masked_l1_loss(t[0], t[1], torch.from_numpy(zero))) == 0.0


@pytest.mark.parametrize("coarse", [False, True])
def test_recon_loss_matches_jax(coarse):
    img, recon, mask = _data(2)
    coarse_img = _data(3)[1] if coarse else None
    want = jlosses.recon_loss(jnp.asarray(img), jnp.asarray(recon), jnp.asarray(mask),
                              None if coarse_img is None else jnp.asarray(coarse_img))
    got = tlosses.recon_loss(torch.from_numpy(img), torch.from_numpy(recon),
                             torch.from_numpy(mask),
                             None if coarse_img is None else torch.from_numpy(coarse_img))
    for g, w in zip(got, want):
        _close(g, w)
    # NCHW with a [B, 1, H, W] mask: the same numbers
    nchw = [torch.from_numpy(a).permute(0, 3, 1, 2) for a in (img, recon, mask)]
    _close(tlosses.recon_loss(*nchw, None if coarse_img is None else
                              torch.from_numpy(coarse_img).permute(0, 3, 1, 2))[0], want[0])


def test_psnr_matches_jax_and_is_inf_at_zero_mse():
    img, other, _ = _data(4)
    _close(tmetrics.psnr(torch.from_numpy(img), torch.from_numpy(other)),
           jmetrics.psnr(jnp.asarray(img), jnp.asarray(other)))
    t = torch.from_numpy(img)
    assert tmetrics.psnr(t, t.clone()).item() == float("inf")


@pytest.mark.parametrize("size", [(64, 128, 3), (37, 53, 3), (20, 31, 1), (5, 8, 2)])
def test_ssim_matches_jax(size):
    img, other, _ = _data(5, 2, *size)
    got = tmetrics.ssim(torch.from_numpy(img), torch.from_numpy(other))
    _close(got, jmetrics.ssim(jnp.asarray(img), jnp.asarray(other)))
    assert got.item() <= 1.0
    t = torch.from_numpy(img)
    assert abs(tmetrics.ssim(t, t.clone()).item() - 1.0) <= 1e-6


def test_ssim_window_is_even_with_zero_padding():
    """The window is 4x4 with its peak at offset 0 (taps at -2..1), and a
    constant image compared with itself is 1 over the whole (H + 1) x
    (W + 1) map, the zero-padded rim too."""
    from ocflow_torch.metrics.image_metrics import _gaussian_window

    w = _gaussian_window(4, 1.5)
    assert w.shape == (4, 4) and abs(w.sum() - 1.0) < 1e-6
    assert np.argmax(w[2]) == 2  # the peak at offset 0, the taps at -2..1
    x = torch.full((1, 6, 7, 1), 0.3)
    assert abs(tmetrics.ssim(x, x).item() - 1.0) <= 1e-6


@pytest.mark.parametrize("metric", ["psnr", "ssim"])
def test_calculate_means_over_batches_match_jax(metric):
    """The mean over batches of each batch's metric of ``recon * mask + img
    * (1 - mask)``, with a deterministic inpainting function on both
    sides."""
    batches = []
    for seed in (6, 7, 8):
        img, _, mask = _data(seed, b=2 if seed < 8 else 1)
        batches.append({"image": img, "occ": mask})

    def j_fn(imgs, masks):
        return jnp.tanh(jnp.asarray(imgs) * 0.7 + jnp.asarray(masks) * 0.2)

    def t_fn(imgs, masks):
        return torch.tanh(imgs * 0.7 + masks * 0.2)

    want = getattr(jmetrics, f"calculate_{metric}")(j_fn, batches)
    got = getattr(tmetrics, f"calculate_{metric}")(
        t_fn, [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches])
    _close(got, want)
