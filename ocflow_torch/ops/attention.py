"""Spatial self-attention over tokens, dense and blockwise (port of
``ocflow_tpu/ops/attention.py``).

``dense_attention`` builds the whole (N x N) score matrix;
``blockwise_attention`` computes the same softmax attention exactly while it
streams over key/value blocks with a running max and sum (the flash
recurrence), so its memory is O(N * block) instead of O(N^2): at the 448x1024
inpainting resolution the refine branch attends over 28,672 tokens, whose
dense scores are 3.3 GB an image in fp32. Its backward is the FlashAttention
adjoint: it saves only ``(q, k, v, out, logsumexp)`` and recomputes each
block's probabilities. ``spatial_self_attention`` picks between them by the
token count. There is no ``1 / sqrt(d)`` scale (the reference has none).
The products are ``torch.matmul``: the reference leaves them to XLA, outside
any Pallas kernel.

Accumulators are at least fp32 (``promote_types(dtype, float32)``): bf16 and
fp32 inputs sum in fp32, as the reference's ``astype(float32)``; fp64 inputs
stay fp64, where the reference casts them down to fp32.

``spatial_self_attention`` and the blockwise backward run inside the
profiler range ``RANGE`` (``torch.profiler.record_function``: nothing is
recorded unless a profiler runs), so a trace can tell the attention's
kernels from the rest of a step; the dense path's backward is autograd's,
outside it.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

RANGE = "ocflow_torch.attention"


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``softmax(q k^T) v`` over tokens. q, k: [B, N, D]; v: [B, N, C]."""
    attn = torch.softmax(torch.matmul(q, k.transpose(1, 2)), dim=-1)
    return torch.matmul(attn, v)


def _blocks(t: torch.Tensor, block_size: int):
    return t.split(block_size, dim=1)


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.promote_types(t.dtype, torch.float32)


def _blockwise_forward(q, k, v, block_size):
    """The flash forward: ``(out [B, N, C] in v's dtype, logsumexp [B, N, 1])``."""
    acc_dt = _acc_dtype(q)
    b, n, _ = q.shape
    qf = q.to(acc_dt)
    m = torch.full((b, n, 1), float("-inf"), dtype=acc_dt, device=q.device)
    l = torch.zeros((b, n, 1), dtype=acc_dt, device=q.device)
    acc = torch.zeros((b, n, v.shape[-1]), dtype=acc_dt, device=q.device)
    for kblk, vblk in zip(_blocks(k, block_size), _blocks(v, block_size)):
        s = torch.matmul(qf, kblk.to(acc_dt).transpose(1, 2))  # [B, N, block]
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        scale = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * scale + p.sum(dim=-1, keepdim=True)
        acc = acc * scale + torch.matmul(p, vblk.to(acc_dt))
        m = m_new
    return (acc / l).to(v.dtype), m + torch.log(l)


class _BlockwiseAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, block_size):
        out, lse = _blockwise_forward(q, k, v, block_size)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.block_size = block_size
        return out

    @staticmethod
    @record_function(RANGE)
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        acc_dt = _acc_dtype(q)
        qf, gf = q.to(acc_dt), g.to(acc_dt)
        # D_i = sum_c dout_ic out_ic, the softmax Jacobian's row term
        delta = (gf * out.to(acc_dt)).sum(dim=-1, keepdim=True)
        dq = torch.zeros_like(qf)
        dks, dvs = [], []
        for kblk, vblk in zip(_blocks(k, ctx.block_size), _blocks(v, ctx.block_size)):
            kf = kblk.to(acc_dt)
            p = torch.exp(torch.matmul(qf, kf.transpose(1, 2)) - lse)  # this block's probabilities
            dvs.append(torch.matmul(p.transpose(1, 2), gf))
            ds = p * (torch.matmul(gf, vblk.to(acc_dt).transpose(1, 2)) - delta)
            dq = dq + torch.matmul(ds, kf)
            dks.append(torch.matmul(ds.transpose(1, 2), qf))
        return (dq.to(q.dtype), torch.cat(dks, 1).to(k.dtype),
                torch.cat(dvs, 1).to(v.dtype), None)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        block_size: int = 1024) -> torch.Tensor:
    """Exact streaming softmax attention (flash recurrence over KV blocks).
    q, k: [B, N, D]; v: [B, N, C]; N a multiple of ``block_size``. Returns
    [B, N, C], equal to :func:`dense_attention` up to rounding; its backward
    recomputes each block's probabilities from the saved logsumexp."""
    if q.shape[1] % block_size:
        raise ValueError(f"{q.shape[1]} tokens: want a multiple of block_size {block_size}")
    return _BlockwiseAttention.apply(q, k, v, block_size)


def spatial_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           block_threshold: int = 4096,
                           block_size: int = 1024) -> torch.Tensor:
    """Blockwise when ``N > block_threshold`` and ``N`` is a multiple of
    ``block_size``, dense otherwise. q, k: [B, N, D]; v: [B, N, C]."""
    n = q.shape[1]
    with record_function(RANGE):
        if n > block_threshold and n % block_size == 0:
            return blockwise_attention(q, k, v, block_size)
        return dense_attention(q, k, v)
