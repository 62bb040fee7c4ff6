"""Learning-rate range test (port of ``ocflow_tpu/train/lr_finder.py``, the
reference's ``find_best_lr``).

Sweeps the learning rate exponentially from ``min_lr`` to ``max_lr`` over
``num_steps`` Adam steps (update k at ``min_lr * r**k``, as the JAX
package's ``optax.inject_hyperparams(adam)`` under an exponential
schedule), tracks the smoothed training loss, stops where it diverges, and
suggests the learning rate of the steepest descent (``np.gradient`` of the
smoothed loss over ``log(lr)``): the Smith (2015) recipe.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np


def lr_find(make_state: Callable[[float], object], make_steps: Callable,
            batches: Iterable[dict], min_lr: float = 1e-7, max_lr: float = 1.0,
            num_steps: int = 100, smoothing: float = 0.05,
            divergence_factor: float = 4.0):
    """Run the range test.

    Args:
        make_state: ``fn(learning_rate) -> TrainState`` with fresh weights.
        make_steps: ``fn() -> (train_step, eval_step)``.
        batches: training batches, cycled (those seen so far, in order) up
            to ``num_steps``.

    Returns:
        ``(suggested_lr, lrs, smoothed_losses)``.
    """
    rate = (max_lr / min_lr) ** (1.0 / max(num_steps - 1, 1))
    state = make_state(min_lr)
    train_step, _ = make_steps()

    lrs, losses_log = [], []
    avg = None
    best = np.inf
    it = iter(batches)
    pool = []
    for step in range(num_steps):
        try:
            batch = next(it)
        except StopIteration:
            if not pool:
                break
            batch = pool[step % len(pool)]
        else:
            pool.append(batch)
        lr = min_lr * rate ** step
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state, metrics = train_step(state, batch)
        loss = float(metrics["loss"])
        if not np.isfinite(loss):
            break
        avg = loss if avg is None else (1 - smoothing) * avg + smoothing * loss
        lrs.append(lr)
        losses_log.append(avg)
        best = min(best, avg)
        if avg > divergence_factor * best:
            break

    if len(lrs) < 3:
        return min_lr, lrs, losses_log
    grads = np.gradient(np.asarray(losses_log), np.log(np.asarray(lrs)))
    return float(lrs[int(np.argmin(grads))]), lrs, losses_log
