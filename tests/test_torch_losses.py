"""The port's losses and occlusion ops == ``ocflow_tpu``'s, on the CPU.

Same numpy inputs (seeded) through both packages, fp32; the port computes
NCHW, the JAX package NHWC. Bounds: 1e-6 relative on the scalar losses
(fp32 summation order over at most 2x32x64x49 terms), exact on the
occlusion masks (thresholds of identical fp32 arithmetic), 1e-5 on the
range map (the same fp32 adds in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocflow_torch import losses
from ocflow_torch.ops import (compute_range_map, occlusion_fb_consistency,
                              occlusion_from_back_flow)
from ocflow_tpu import losses as jlosses
from ocflow_tpu.ops import range_map as jrange
from test_torch_ops import share_cores  # noqa: F401  (autouse)

B, H, W = 2, 32, 64
LOSS_RTOL = 1e-6


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _images(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    b = (a + rng.normal(size=a.shape) * 0.1).astype(np.float32)
    occ = (rng.uniform(size=(B, H, W, 1)) > 0.6).astype(np.float32)
    return a, b, occ


def _close(got, want, rtol=LOSS_RTOL):
    np.testing.assert_allclose(float(got), float(want), rtol=rtol, atol=1e-9)


def test_robust_l1():
    x = np.array([0.0, 1.0, -2.0], np.float32)
    np.testing.assert_allclose(losses.robust_l1(torch.from_numpy(x)).numpy(),
                               np.asarray(jlosses.robust_l1(jnp.asarray(x))), rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_photometric_error(masked):
    a, b, occ = _images(0)
    got = losses.photometric_error(_nchw(a), _nchw(b), _nchw(occ) if masked else None)
    want = jlosses.photometric_error(jnp.asarray(a), jnp.asarray(b),
                                     jnp.asarray(occ) if masked else None)
    _close(got, want)


def test_census_transform_patch_order():
    """``F.unfold`` on a 1-channel image gives the (kh, kw) row-major patch
    order of ``conv_general_dilated_patches``. Bound 5e-5: grey values up to
    255 may differ by one fp32 ulp (1.5e-5) between the two channel means,
    and ``d / sqrt(0.81 + d^2)`` has slope 1.1 near 0."""
    a, _, _ = _images(1)
    got = losses.census_transform(_nchw(a)).numpy()
    want = np.asarray(jlosses.census_transform(jnp.asarray(a))).transpose(0, 3, 1, 2)
    assert got.shape == (B, 49, H, W)
    np.testing.assert_allclose(got, want, atol=5e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_census_loss(masked):
    a, b, occ = _images(2)
    got = losses.census_loss(_nchw(a), _nchw(b), _nchw(occ) if masked else None)
    want = jlosses.census_loss(jnp.asarray(a), jnp.asarray(b),
                               jnp.asarray(occ) if masked else None)
    _close(got, want, rtol=2e-6)


@pytest.mark.parametrize("name", [
    "first_order_smoothness_loss", "second_order_smoothness_loss",
    "edge_aware_smoothness_loss"])
def test_smoothness(name):
    rng = np.random.default_rng(3)
    img = (rng.standard_normal((B, H, W, 3)) * 0.01).astype(np.float32)
    flow = rng.standard_normal((B, H, W, 2)).astype(np.float32)
    got = getattr(losses, name)(_nchw(img), _nchw(flow))
    want = getattr(jlosses, name)(jnp.asarray(img), jnp.asarray(flow))
    assert float(got) > 0
    _close(got, want, rtol=2e-6)


def test_image_gradient():
    rng = np.random.default_rng(4)
    img = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    for stride in (1, 2):
        for g, j in zip(losses.image_gradient(_nchw(img), stride),
                        jlosses.image_gradient(jnp.asarray(img), stride)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(j).transpose(0, 3, 1, 2))


def test_binary_cross_entropy():
    rng = np.random.default_rng(5)
    pred = rng.uniform(0, 1, (B, H, W, 1)).astype(np.float32)
    pred[0, 0, :4, 0] = [0.0, 1.0, 1e-9, 1 - 1e-9]
    target = (rng.uniform(size=(B, H, W, 1)) > 0.5).astype(np.float32)
    _close(losses.binary_cross_entropy(_nchw(pred), _nchw(target)),
           jlosses.binary_cross_entropy(jnp.asarray(pred), jnp.asarray(target)))


def _flows(seed, scale=4.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, W, 2)) * scale).astype(np.float32)


def test_compute_range_map():
    """Flows reaching past every border (invalid taps weigh 0)."""
    flow = _flows(6, scale=8.0)
    got = compute_range_map(_nchw(flow))
    want = np.asarray(jrange.compute_range_map(jnp.asarray(flow)))
    assert got.shape == (B, 1, H, W) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.transpose(0, 3, 1, 2), atol=1e-5)


def test_range_map_cases():
    """Zero flow covers every pixel once; a uniform right shift by 3 leaves
    the left strip unreferenced (the JAX package's cases)."""
    np.testing.assert_allclose(compute_range_map(torch.zeros(1, 2, 8, 8)).numpy(), 1.0)
    flow = torch.zeros(1, 2, 8, 8)
    flow[:, 0] = 3.0
    occ = occlusion_from_back_flow(flow)[0, 0].numpy()
    np.testing.assert_allclose(occ[:, :3], 1.0)
    np.testing.assert_allclose(occ[:, 3:], 0.0)


def test_occlusion_from_back_flow():
    flow = _flows(7)
    got = occlusion_from_back_flow(_nchw(flow)).numpy()
    want = np.asarray(jrange.occlusion_from_back_flow(jnp.asarray(flow)))
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), atol=1e-5)


@pytest.mark.parametrize("case", ["random", "inverse", "broken"])
def test_occlusion_fb_consistency(case):
    """On identical flows: random pairs, an exact inverse (visible but for
    the frame's edge) and one whose backward half contradicts it."""
    if case == "random":
        fwd, bwd = _flows(8), _flows(9)
    else:
        fwd = np.zeros((B, H, W, 2), np.float32)
        fwd[..., 0] = 2.0
        bwd = -fwd
        if case == "broken":
            bwd[:, :, W // 2:, 0] = 4.0
    got = occlusion_fb_consistency(_nchw(fwd), _nchw(bwd)).numpy()
    want = np.asarray(jrange.occlusion_fb_consistency(jnp.asarray(fwd), jnp.asarray(bwd)))
    assert 0 < got.mean() < 1
    np.testing.assert_array_equal(got, want.transpose(0, 3, 1, 2))
