"""The cost volume past the tuned kernels' d = 10, on the CPU.

The port's cost volume at d = 11 and 12 (the plain version, which CPU
tensors take) against the JAX package's ``cost_volume_fused`` (its XLA cost
volume there, as at any d its Pallas block does not fit) and that op's VJP
(``_bwd_xla_mirror``), within 1e-5 of max|JAX|. The general CUDA kernels of
``csrc/cost_volume_any.cu`` run only on the card (``tests/test_torch_gpu.py``
holds them against the plain version); here their index arithmetic, one
output element per thread with the taps gathered as the source writes them,
is emulated in numpy at a small size and held against the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocflow_torch.kernels import cost_volume as cv_mod
from ocflow_tpu.ops.pallas import cost_volume_kernel as jcv
from test_torch_ops import share_cores  # noqa: F401  (autouse)

TOL = 1e-5


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _inputs(d, shape, seed=0):
    rng = np.random.default_rng(seed)
    f1 = rng.standard_normal(shape).astype(np.float32)
    f2 = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal((*shape[:3], (2 * d + 1) ** 2)).astype(np.float32)
    return f1, f2, g


def _close(got, want):
    want = np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= TOL * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("d, shape", [(11, (2, 20, 28, 16)), (12, (1, 26, 30, 13))])
def test_cost_volume_past_d10_matches_jax(d, shape):
    """Forward and VJP; at d = 12 the 30-wide map is narrower than the
    25 x 25 shift window's reach on each side of most pixels."""
    f1, f2, g = _inputs(d, shape)
    want, vjp = jax.vjp(lambda a, b: jcv.cost_volume_fused(a, b, d),
                        jnp.asarray(f1), jnp.asarray(f2))
    t1, t2 = _nchw(f1).requires_grad_(), _nchw(f2).requires_grad_()
    got = cv_mod.cost_volume(t1, t2, d)
    _close(_nhwc(got), want)
    got.backward(_nchw(g))
    for a, b in zip((t1.grad, t2.grad), vjp(jnp.asarray(g))):
        _close(_nhwc(a), b)


def _kernel_forward(f1, f2, d):
    """``cost_volume_any_fwd_kernel``: each (b, s, y, x) sums over c in
    fp32, taps outside the image give 0, then / C."""
    b, c, h, w = f1.shape
    n = 2 * d + 1
    out = np.zeros((b, n * n, h, w), np.float32)
    for s in range(n * n):
        dy, dx = s // n - d, s % n - d
        for y in range(h):
            if not 0 <= y + dy < h:
                continue
            for x in range(w):
                if 0 <= x + dx < w:
                    out[:, s, y, x] = (f1[:, :, y, x] * f2[:, :, y + dy, x + dx]).sum(1)
    return out / np.float32(c)


def _kernel_backward(f1, f2, g, d):
    """``cost_volume_any_bwd_kernel``: df1 gathers the cotangent at its own
    pixel times f2 at the shifted tap; df2 gathers, for each shift, the
    cotangent and f1 at the pixel whose tap lands on it."""
    b, c, h, w = f1.shape
    n = 2 * d + 1
    df1, df2 = np.zeros_like(f1), np.zeros_like(f2)
    for i in range(n):
        for j in range(n):
            gk = g[:, i * n + j][:, None]
            for y in range(h):
                for x in range(w):
                    yy, xx = y + i - d, x + j - d
                    if 0 <= yy < h and 0 <= xx < w:
                        df1[:, :, y, x] += gk[:, :, y, x] * f2[:, :, yy, xx]
                    yy, xx = y - (i - d), x - (j - d)
                    if 0 <= yy < h and 0 <= xx < w:
                        df2[:, :, y, x] += gk[:, :, yy, xx] * f1[:, :, yy, xx]
    return df1 * np.float32(1.0 / c), df2 * np.float32(1.0 / c)


@pytest.mark.parametrize("kind", ["forward", "backward"])
@pytest.mark.parametrize("d", [11, 12])
def test_general_kernel_index_math_matches_plain(kind, d):
    """The general kernels' gather on a map smaller than the shift window
    (9 x 14, d = 11 and 12: most taps fall outside), against the plain
    version."""
    f1, f2, g = (np.ascontiguousarray(a.transpose(0, 3, 1, 2))
                 for a in _inputs(d, (2, 9, 14, 5), seed=d))
    t1, t2, tg = (torch.from_numpy(a) for a in (f1, f2, g))
    if kind == "forward":
        pairs = [(_kernel_forward(f1, f2, d), cv_mod.cost_volume_plain(t1, t2, d))]
    else:
        pairs = zip(_kernel_backward(f1, f2, g, d),
                    cv_mod.cost_volume_backward_plain(t1, t2, tg, d))
    for got, want in pairs:
        _close(got, want.numpy())
