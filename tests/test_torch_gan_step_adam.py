"""One SN-PatchGAN train step of the port against the JAX package's with
the optimizers the CLIs give the pair: Adam at the learning rate for the
generator, Adam at 4x for the discriminator (``torch.optim.Adam`` against
``optax.adam``), the projected nets, 2x64x128, the weights and batch of
``tests/test_torch_gan_step.py``. In fp64 the parameters of both nets after
the step within 1e-6 of the tensor's max|param| (a zero-initialized bias
whose gradient is zero, which Adam moves by ``lr * g / (|g| + eps)`` with
``g`` rounding, about 1e-11 here: within 1e-6 of the net's max|param| in
both packages); the fp32 step's readings
are printed (the train-mode BatchNorms put fp32 gradients far apart in
either package, ``tests/test_torch_gan_nets.py``; Adam's first step moves a
weight by about the learning rate whatever its gradient's size)."""

import numpy as np
import optax
import torch

from test_torch_gan_step import (dis_to_flax, gen_flax, hold_tensors, leaves, per_tensor,
                                 run_gan_steps, zero_tensors)
from test_torch_ops import share_cores  # noqa: F401  (autouse)

PARAM_REL = 1e-6


def _params(kind):
    """``{net: (port, jax, names of the zero gradients)}`` parameters after
    one Adam step in ``kind`` (the gradients from optax's first moment), and
    the metrics' relative gaps."""
    (gs, ds), metrics, (jgen, jdis), jmetrics = run_gan_steps(
        "gated", kind, jax_tx=optax.adam, port_opt=torch.optim.Adam, dis_lr_scale=4.0)
    assert ds.optimizer.param_groups[0]["lr"] == 4 * gs.optimizer.param_groups[0]["lr"]
    return ({"G": (leaves(gen_flax(gs.model)["params"]), leaves(jgen.params),
                   zero_tensors(leaves(jgen.opt_state[0].mu))),
             "D": (leaves(dis_to_flax(ds.model.state_dict(), True)[0]), leaves(jdis.params),
                   zero_tensors(leaves(jdis.opt_state[0].mu)))},
            {k: abs(metrics[k] - v) / abs(v) for k, v in jmetrics.items()})


def test_gan_step_adam_matches_optax():
    params, _ = _params("fp64")
    for net, (got, want, zero) in params.items():
        hold_tensors(net, got, want, PARAM_REL, zero)
    params, metrics = _params("fp32")
    for net, (got, want, _) in params.items():
        e = per_tensor(got, want)
        worst = max(e, key=e.get)
        print(f"fp32 {net}: worst parameter {worst} {e[worst]:.3e} of max|param|, median "
              f"{np.median(list(e.values())):.3e}")
    print("fp32 metrics, relative:", {k: f"{v:.3e}" for k, v in metrics.items()})
