"""The port's learning-rate range test (``train.lr_finder.lr_find``) ==
``ocflow_tpu.train.lr_finder.lr_find`` on a tiny net (one 3x3 conv from the
two frames to the flow, the same weights on both sides) under the
supervised flow step, over a pool of 3 numpy batches cycled for 40 steps:
the learning rates within 1e-6 relative (the JAX schedule evaluates in
fp32), the smoothed losses within 1e-4 relative (40 Adam steps apart in
summation order), the same suggestion; and the divergence stop."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from ocflow_torch.train import create_train_state, lr_find, make_supervised_flow_step
from ocflow_tpu.train import TrainState as JTrainState
from ocflow_tpu.train import steps as jsteps
from ocflow_tpu.train.lr_finder import lr_find as jlr_find
from test_torch_ops import share_cores  # noqa: F401  (autouse)


class _JTiny(nn.Module):
    @nn.compact
    def __call__(self, x, train: bool = False):
        return nn.Conv(2, (3, 3), padding=((1, 1), (1, 1)))(x)


class _Tiny(torch.nn.Module):
    def __init__(self, kernel, bias):
        super().__init__()
        self.conv = torch.nn.Conv2d(6, 2, 3, padding=1)
        with torch.no_grad():
            self.conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()))
            self.conv.bias.copy_(torch.from_numpy(bias.copy()))

    def forward(self, x):
        return self.conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _batches(n=3):
    rng = np.random.default_rng(0)
    return [{"images": rng.uniform(-1, 1, (2, 8, 12, 6)).astype(np.float32),
             "flow": rng.normal(size=(2, 8, 12, 2)).astype(np.float32)} for _ in range(n)]


def _run(batches, **kw):
    params = _JTiny().init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 12, 6)))["params"]
    kernel, bias = (np.asarray(params["Conv_0"][k]) for k in ("kernel", "bias"))
    ref = jlr_find(lambda tx: JTrainState.create(apply_fn=_JTiny().apply, params=params, tx=tx),
                   lambda: jsteps.make_supervised_flow_step({}),
                   [{k: jnp.asarray(v) for k, v in b.items()} for b in batches], **kw)
    got = lr_find(lambda lr: create_train_state(_Tiny(kernel, bias), lr, device="cpu"),
                  lambda: make_supervised_flow_step({}),
                  [{k: torch.from_numpy(v) for k, v in b.items()} for b in batches], **kw)
    return got, ref


def test_lr_find_matches_jax():
    (s, lrs, losses), (rs, rlrs, rlosses) = _run(_batches(), min_lr=1e-5, max_lr=1e-1,
                                                 num_steps=40)
    assert len(lrs) == len(rlrs) == 40
    np.testing.assert_allclose(lrs, rlrs, rtol=1e-6)
    np.testing.assert_allclose(losses, rlosses, rtol=1e-4)
    assert lrs.index(s) == rlrs.index(rs)
    assert abs(s - rs) <= 1e-6 * rs


def test_lr_find_stops_where_the_loss_diverges():
    """Up to lr 100 the smoothed loss passes 4x its best: both stop at the
    same step, before ``num_steps``."""
    (_, lrs, _), (_, rlrs, _) = _run(_batches(), min_lr=1e-3, max_lr=1e2, num_steps=60)
    assert len(lrs) == len(rlrs) < 60
