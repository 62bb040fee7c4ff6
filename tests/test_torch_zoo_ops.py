"""The port's pooling ops and straight-through estimator
(``ocflow_torch.ops.pooling``, ``ocflow_torch.ops.ste``, NCHW) ==
``ocflow_tpu.ops.pooling`` and ``ocflow_tpu.ops.ste`` (NHWC), on the CPU.

The pooled values, the argmax and the unpooled maps are exact (no
arithmetic but the one-hot multiply), on odd sizes (ceil mode) and on
inputs with tied maxima (the first maximum, as ``jnp.argmax``); the
pooling's gradient, shared among tied maxima as ``jnp.max``'s, within
1e-6; the STE's forward exact (an input at 0.5 maps to 0) and its gradient
the identity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocflow_torch.ops import pooling as tpool
from ocflow_torch.ops.ste import hard_threshold_ste
from ocflow_tpu.ops import pooling as jpool
from ocflow_tpu.ops.ste import hard_threshold_ste as j_ste
from test_torch_ops import share_cores  # noqa: F401  (autouse)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _input(shape, ties, seed):
    """NHWC values; with ``ties``, small integers, so that most windows hold
    a tied maximum."""
    rng = np.random.default_rng(seed)
    if ties:
        return rng.integers(-2, 3, shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", [(2, 8, 12, 3), (2, 7, 9, 4), (1, 5, 6, 2), (1, 1, 3, 5)])
def test_max_pool_with_argmax_matches_jax(shape, ties):
    x = _input(shape, ties, sum(shape) + ties)
    ref, ref_idx = jpool.max_pool_2x2_with_argmax(jnp.asarray(x))
    got, idx = tpool.max_pool_2x2_with_argmax(_nchw(x))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(ref))
    np.testing.assert_array_equal(_nhwc(idx), np.asarray(ref_idx))
    np.testing.assert_array_equal(_nhwc(tpool.max_pool_2x2(_nchw(x))),
                                  np.asarray(jpool.max_pool_2x2(jnp.asarray(x))))
    if ties:  # the case under test is there
        win = tpool._windows(_nchw(x))
        assert ((win == win.amax(-1, keepdim=True)).sum(-1) > 1).any()

    # the gradient of a weighted sum of the pooled map
    w = np.random.default_rng(5).normal(size=np.asarray(ref).shape).astype(np.float32)
    jg = jax.grad(lambda a: (jpool.max_pool_2x2(a) * w).sum())(jnp.asarray(x))
    xt = _nchw(x).requires_grad_()
    (tpool.max_pool_2x2(xt) * _nchw(w)).sum().backward()
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(jg), atol=1e-6)


@pytest.mark.parametrize("shape,out_size", [((2, 8, 12, 3), None), ((2, 7, 9, 4), (7, 9)),
                                            ((1, 5, 6, 2), (5, 6))])
def test_max_unpool_matches_jax(shape, out_size):
    x = _input(shape, True, 3)
    pooled, idx = jpool.max_pool_2x2_with_argmax(jnp.asarray(x))
    vals = np.random.default_rng(4).normal(size=np.asarray(pooled).shape).astype(np.float32)
    ref = np.asarray(jpool.max_unpool_2x2(jnp.asarray(vals), idx, out_size))
    got = tpool.max_unpool_2x2(_nchw(vals), _nchw(np.asarray(idx)).long(), out_size)
    assert got.shape == _nchw(ref).shape
    np.testing.assert_array_equal(_nhwc(got), ref)
    # pooling then unpooling keeps each window's first maximum only
    p, i = tpool.max_pool_2x2_with_argmax(_nchw(x))
    kept = tpool.max_unpool_2x2(p, i, out_size or shape[1:3])
    assert int((kept != 0).sum()) <= p.numel()


def test_ste_matches_jax():
    soft = np.random.default_rng(6).uniform(size=(2, 1, 9, 11)).astype(np.float32)
    soft[0, 0, 0, :3] = (0.5, np.nextafter(np.float32(0.5), np.float32(1)), 0.0)
    ref = np.asarray(j_ste(jnp.asarray(soft)))
    t = torch.from_numpy(soft).requires_grad_()
    got = hard_threshold_ste(t)
    np.testing.assert_array_equal(got.detach().numpy(), ref)
    assert got[0, 0, 0, 0] == 0 and got[0, 0, 0, 1] == 1
    assert set(np.unique(ref)) <= {0.0, 1.0}
    w = np.random.default_rng(7).normal(size=soft.shape).astype(np.float32)
    (got * torch.from_numpy(w)).sum().backward()
    jg = jax.grad(lambda a: (j_ste(a) * w).sum())(jnp.asarray(soft))
    np.testing.assert_array_equal(t.grad.numpy(), w)
    np.testing.assert_array_equal(np.asarray(jg), w)
