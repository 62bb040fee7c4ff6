"""The port's plain ops (ocflow_torch.ops, NCHW) == ocflow_tpu.ops (NHWC).

Same inputs from numpy seeds through both, fp32 on the CPU. Tolerance 1e-5
absolute on O(1) values: only summation order differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocflow_torch import ops as tops
from ocflow_tpu.ops.cost_volume import cost_volume as j_cost_volume
from ocflow_tpu.ops.cost_volume import normalize_features as j_normalize
from ocflow_tpu.ops.resize import resize_bilinear as j_resize
from ocflow_tpu.ops.warp import flow_to_warp as j_flow_to_warp
from ocflow_tpu.ops.warp import warp as j_warp

ATOL = 1e-5


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("c", [3, 32, 96])
def test_warp_matches_jax(align_corners, c):
    rng = np.random.default_rng(c)
    b, h, w = 2, 12, 20
    img = rng.normal(size=(b, h, w, c)).astype(np.float32)
    # flows large enough that many taps leave the image
    flow = (rng.normal(size=(b, h, w, 2)) * 6.0).astype(np.float32)
    ref = np.asarray(j_warp(jnp.asarray(img), jnp.asarray(flow),
                            align_corners=align_corners))
    got = tops.warp(_nchw(img), _nchw(flow), align_corners=align_corners)
    np.testing.assert_allclose(_nhwc(got), ref, atol=ATOL)


def test_flow_to_warp_matches_jax():
    rng = np.random.default_rng(1)
    flow = rng.normal(size=(2, 5, 7, 2)).astype(np.float32)
    ref = np.asarray(j_flow_to_warp(jnp.asarray(flow)))
    np.testing.assert_allclose(_nhwc(tops.flow_to_warp(_nchw(flow))), ref,
                               atol=ATOL)


def test_warp_bf16_keeps_fp32_coordinates():
    """bf16 features, flows past x=256: the port samples at fp32 positions
    (a bf16 grid would land on whole pixels) and matches fp32 sampling to
    bf16 rounding of the result."""
    rng = np.random.default_rng(2)
    b, c, h, w = 1, 4, 4, 300
    img = torch.from_numpy(rng.normal(size=(b, c, h, w)).astype(np.float32))
    flow = torch.zeros(b, 2, h, w)
    flow[:, 0] = 0.37
    got = tops.warp(img.bfloat16(), flow, align_corners=True).float()
    ref = tops.warp(img.bfloat16().float(), flow, align_corners=True)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-2, rtol=1e-2)


def test_normalize_features_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.normal(1.5, 2.0, size=(3, 6, 10, 8)).astype(np.float32)
    b = rng.normal(-0.5, 0.7, size=(3, 6, 10, 8)).astype(np.float32)
    ra, rb = j_normalize([jnp.asarray(a), jnp.asarray(b)])
    ga, gb = tops.normalize_features([_nchw(a), _nchw(b)])
    np.testing.assert_allclose(_nhwc(ga), np.asarray(ra), atol=ATOL)
    np.testing.assert_allclose(_nhwc(gb), np.asarray(rb), atol=ATOL)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("size", [(16, 28), (5, 3)])
def test_resize_bilinear_matches_jax(align_corners, size):
    rng = np.random.default_rng(4)
    img = rng.normal(size=(2, 7, 9, 3)).astype(np.float32)
    ref = np.asarray(j_resize(jnp.asarray(img), *size,
                              align_corners=align_corners))
    got = tops.resize_bilinear(_nchw(img), *size, align_corners=align_corners)
    np.testing.assert_allclose(_nhwc(got), ref, atol=ATOL)


@pytest.mark.parametrize("d", [1, 4])
def test_cost_volume_matches_jax(d):
    rng = np.random.default_rng(5)
    f1 = rng.normal(size=(2, 9, 11, 5)).astype(np.float32)
    f2 = rng.normal(size=(2, 9, 11, 5)).astype(np.float32)
    ref = np.asarray(j_cost_volume(jnp.asarray(f1), jnp.asarray(f2), d))
    got = tops.cost_volume(_nchw(f1), _nchw(f2), d)
    assert got.shape == (2, (2 * d + 1) ** 2, 9, 11)
    np.testing.assert_allclose(_nhwc(got), ref, atol=ATOL)
