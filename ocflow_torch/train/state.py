"""Train state (port of ``ocflow_tpu/train/state.py``): the model with its
fp32 master weights, an Adam optimizer and the step counter.

``torch.optim.Adam`` and ``optax.adam`` share their defaults (0.9, 0.999,
1e-8) and their update ``m_hat / (sqrt(v_hat) + eps)``. A net's BatchNorm
statistics (the JAX state's ``batch_stats``) live in the module's buffers:
a train step in train mode updates them in place, and a checkpoint of the
model's ``state_dict`` carries them. A GAN run's state is the pair
``(gen_state, dis_state)``, as the JAX CLI's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ocflow_torch import resolve_device


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def state_device(state) -> torch.device:
    """The device of a ``TrainState``, or of a GAN run's ``(gen_state,
    dis_state)`` pair (the generator's)."""
    return (state[0] if isinstance(state, tuple) else state).device


def create_train_state(model: nn.Module, learning_rate: float,
                       device=None) -> TrainState:
    """``model`` moved to ``device`` (default ``cuda``) in fp32, with
    ``Adam(learning_rate)`` over its parameters."""
    model = model.to(device=resolve_device(device), dtype=torch.float32)
    return TrainState(model, torch.optim.Adam(model.parameters(), lr=learning_rate))
