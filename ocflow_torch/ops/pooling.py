"""2x2 max pooling with argmax indices and the matching max-unpool (port of
``ocflow_tpu/ops/pooling.py``), NCHW.

Dense, as the JAX op: the pool windows become an explicit axis of 4
(index ``2*dy + dx``) by reshapes, the argmax is taken over it (the first
maximum on ties, as ``jnp.argmax``), and unpooling is a one-hot multiply and
the inverse reshape. ``F.max_unpool2d`` reads flat indices into the whole
map: other semantics, so it is not used. Pooling is ceil-mode: an odd size
is padded with -inf on the bottom and the right.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _windows(x: torch.Tensor) -> torch.Tensor:
    """``[B, C, H, W]`` -> ``[B, C, ceil(H/2), ceil(W/2), 4]``, the 2x2
    windows in the order ``2*dy + dx``."""
    ph, pw = x.shape[2] % 2, x.shape[3] % 2
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), value=float("-inf"))
    b, c, h, w = x.shape
    win = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 1, 2, 4, 3, 5)
    return win.reshape(b, c, h // 2, w // 2, 4)


def max_pool_2x2_with_argmax(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``[B, C, H, W]`` -> (pooled ``[B, C, ceil(H/2), ceil(W/2)]``, argmax
    of the same shape, int64 in {0..3} = ``2*dy + dx``). The gradient of a
    window with tied maxima is shared among them, as ``jnp.max``'s."""
    win = _windows(x)
    return win.amax(-1), win.argmax(-1)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """Plain 2x2/stride-2 ceil-mode max pool."""
    return _windows(x).amax(-1)


def max_unpool_2x2(x: torch.Tensor, idx: torch.Tensor,
                   out_size: tuple[int, int] | None = None) -> torch.Tensor:
    """The values ``x`` ``[B, C, h, w]`` put back at their argmax ``idx``
    (of the paired pool) on a ``[B, C, 2h, 2w]`` canvas of zeros, cropped
    to ``out_size`` ``(H, W)`` when given (odd inputs)."""
    b, c, h, w = x.shape
    onehot = F.one_hot(idx, 4).to(x.dtype)  # [B, C, h, w, 4]
    win = (x[..., None] * onehot).reshape(b, c, h, w, 2, 2).permute(0, 1, 2, 4, 3, 5)
    out = win.reshape(b, c, 2 * h, 2 * w)
    if out_size is not None:
        out = out[:, :, :out_size[0], :out_size[1]]
    return out
