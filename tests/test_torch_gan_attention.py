"""The port's attention (``ocflow_torch/ops/attention.py``) against
``ocflow_tpu/ops/attention.py`` on the CPU: ``dense_attention``,
``blockwise_attention`` (the flash forward and its adjoint) and the dispatch
of ``spatial_self_attention``; the ``SelfAttention`` module of the gated
generators on its blockwise path.

Inputs from a numpy seed, cotangents too; forwards and the gradients of q,
k and v. fp32: within 1e-5 of max|.|. fp64 (``jax.enable_x64``): within
1e-12. The JAX blockwise path casts its inputs to fp32 whatever their type
(``astype(jnp.float32)``), the port's sums in fp64 for fp64 inputs: in fp64
the port's blockwise attention is held against the JAX dense attention and
its own dense one at 1e-12, and against the JAX blockwise one at the fp32
bound (the reference's own rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocflow_torch.models.gated_conv import SelfAttention
from ocflow_torch.ops import attention as tatt
from ocflow_tpu.models import gated_conv as jg
from ocflow_tpu.ops import attention as jatt
from test_torch_ops import share_cores  # noqa: F401  (autouse)

TOL = {"fp32": 1e-5, "fp64": 1e-12}
DTYPES = {"fp32": (np.float32, torch.float32), "fp64": (np.float64, torch.float64)}


def _inputs(kind, b=2, n=128, d=4, c=32, seed=0):
    rng = np.random.default_rng(seed)
    npdt = DTYPES[kind][0]
    q, k = (rng.normal(size=(b, n, d)).astype(npdt) * 1.5 for _ in range(2))
    v = rng.normal(size=(b, n, c)).astype(npdt)
    g = rng.normal(size=(b, n, c)).astype(npdt)
    return q, k, v, g


def _jax(fn, q, k, v, g, kind):
    with jax.enable_x64(kind == "fp64"):
        out, vjp = jax.vjp(jax.jit(fn), *(jnp.asarray(a) for a in (q, k, v)))
        grads = vjp(jnp.asarray(g))
        return [np.asarray(a) for a in (out, *grads)]


def _port(fn, q, k, v, g):
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fn(*ts)
    out.backward(torch.from_numpy(g))
    return [t.detach().numpy() for t in (out, *(a.grad for a in ts))]


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _hold(got, want, tol):
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want, strict=True):
        assert a.dtype == b.dtype, name
        assert _rel(a, b) <= tol, (name, _rel(a, b))


@pytest.mark.parametrize("kind", ["fp32", "fp64"])
def test_dense_attention_matches_jax(kind):
    args = _inputs(kind)
    _hold(_port(tatt.dense_attention, *args), _jax(jatt.dense_attention, *args, kind),
          TOL[kind])


@pytest.mark.parametrize("kind", ["fp32", "fp64"])
def test_blockwise_attention_matches_jax_and_dense(kind):
    """Four KV blocks of 32 over 128 tokens: the port's blockwise path
    against the JAX blockwise path, the JAX dense path and its own dense
    path (see the module docstring for fp64)."""
    args = _inputs(kind)
    got = _port(lambda q, k, v: tatt.blockwise_attention(q, k, v, 32), *args)
    jblock = _jax(lambda q, k, v: jatt.blockwise_attention(q, k, v, 32), *args, kind)
    _hold(got, jblock, TOL["fp32"])
    _hold(got, _jax(jatt.dense_attention, *args, kind), TOL[kind])
    _hold(got, _port(tatt.dense_attention, *args), TOL[kind])


def test_blockwise_backward_saves_no_score_block():
    """The blockwise path's autograd keeps q, k, v, the output and the
    logsumexp, nothing of size N x block."""
    q, k, v, _ = (torch.from_numpy(a).requires_grad_() for a in _inputs("fp32"))
    out = tatt.blockwise_attention(q, k, v, 32)
    saved = out.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [(2, 128, 4), (2, 128, 4), (2, 128, 32),
                                               (2, 128, 32), (2, 128, 1)]
    with pytest.raises(ValueError, match="multiple of block_size"):
        tatt.blockwise_attention(q[:, :100], k[:, :100], v[:, :100], 32)


def test_dispatch_matches_jax_at_the_threshold(monkeypatch):
    """Both packages take the blockwise path exactly when ``N >
    block_threshold`` and ``N`` is a multiple of ``block_size``: at the
    threshold, one block past it, and past it off the block grid."""
    took = []
    real = jatt.blockwise_attention
    monkeypatch.setattr(jatt, "blockwise_attention",
                        lambda *a: took.append(True) or real(*a))
    for n, blockwise in ((64, False), (96, True), (80, False), (128, True)):
        q, k, v, _ = _inputs("fp32", n=n)
        took.clear()
        jout = np.asarray(jatt.spatial_self_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 64, 32))
        tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        out = tatt.spatial_self_attention(tq, tk, tv, 64, 32)
        assert bool(took) == blockwise, n
        assert ("_BlockwiseAttention" in type(out.grad_fn).__name__) == blockwise, n
        assert _rel(out.detach().numpy(), jout) <= TOL["fp32"], n


def test_self_attention_module_blockwise_matches_jax(monkeypatch):
    """``SelfAttention(block_threshold=64, block_size=32)`` in both packages
    on a [2, 8, 16, 32] map (128 tokens: the blockwise path), the same 1x1
    convs and ``gamma`` 0.5 (0 at init would hide the attention): output and
    input gradient within 1e-5 of max|.|."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 16, 32)).astype(np.float32)
    g = rng.normal(size=(2, 8, 16, 32)).astype(np.float32)
    jmod = jg.SelfAttention(block_threshold=64, block_size=32)
    params = jax.tree_util.tree_map(np.array, jax.jit(jmod.init)(jax.random.PRNGKey(0), x))
    params["params"]["gamma"] = np.full((1,), 0.5, np.float32)
    out, vjp = jax.vjp(jax.jit(lambda a: jmod.apply(params, a)), jnp.asarray(x))
    (dx,) = vjp(jnp.asarray(g))

    mod = SelfAttention(32, block_threshold=64, block_size=32)
    p = params["params"]
    with torch.no_grad():
        for j, conv in enumerate((mod.query_conv, mod.key_conv, mod.value_conv)):
            conv.weight.copy_(torch.from_numpy(p[f"Conv_{j}"]["kernel"].transpose(3, 2, 0, 1)))
            conv.bias.copy_(torch.from_numpy(p[f"Conv_{j}"]["bias"]))
        mod.gamma.fill_(0.5)
    took = []
    real = tatt.blockwise_attention
    monkeypatch.setattr(tatt, "blockwise_attention", lambda *a: took.append(True) or real(*a))
    tx = torch.from_numpy(x.transpose(0, 3, 1, 2)).requires_grad_()
    tout = mod(tx)
    assert took == [True]
    tout.backward(torch.from_numpy(g.transpose(0, 3, 1, 2)))
    assert _rel(tout.detach().permute(0, 2, 3, 1).numpy(), np.asarray(out)) <= TOL["fp32"]
    assert _rel(tx.grad.permute(0, 2, 3, 1).numpy(), np.asarray(dx)) <= TOL["fp32"]
