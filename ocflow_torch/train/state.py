"""Train state (port of ``ocflow_tpu/train/state.py``): the model with its
fp32 master weights, an Adam optimizer and the step counter.

``torch.optim.Adam`` and ``optax.adam`` share their defaults (0.9, 0.999,
1e-8) and their update ``m_hat / (sqrt(v_hat) + eps)``. FlowNetCV has no
BatchNorm, so there are no batch statistics to thread.
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


def create_train_state(model: nn.Module, learning_rate: float,
                       device=None) -> TrainState:
    """``model`` moved to ``device`` (default ``cuda``) in fp32, with
    ``Adam(learning_rate)`` over its parameters."""
    model = model.to(device=resolve_device(device), dtype=torch.float32)
    return TrainState(model, torch.optim.Adam(model.parameters(), lr=learning_rate))
