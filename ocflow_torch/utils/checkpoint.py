"""Checkpoints (port of ``ocflow_tpu/utils/checkpoint.py``, with
``torch.save`` in place of Orbax).

A train state's checkpoint is a dict with top-level ``step``, ``params``
(the model's ``state_dict``) and ``opt_state`` (the optimizer's
``state_dict``), loaded with ``torch.load(weights_only=True)``; a GAN run's
is the tuple of its generator's and its discriminator's.
``CheckpointManager`` keeps the best ``max_to_keep`` on a monitored loss;
``load_subtree`` takes a '/'-separated part of a checkpoint (the staged
trainings splice a pretrained network's ``params`` out of one).
"""

from __future__ import annotations

import json
import os
from typing import Any

import torch

from ocflow_torch.train.state import TrainState


def state_tree(state: Any) -> Any:
    """A ``TrainState`` as its checkpoint dict, a tuple of them (a GAN run's
    ``(gen_state, dis_state)``) as a tuple of those; anything else as it
    is."""
    if isinstance(state, TrainState):
        return {"step": state.step, "params": state.model.state_dict(),
                "opt_state": state.optimizer.state_dict()}
    if isinstance(state, tuple):
        return tuple(state_tree(s) for s in state)
    return state


def load_state(state: TrainState, tree: dict) -> TrainState:
    """Load a checkpoint dict into ``state``'s model and optimizer (the
    tensors are copied onto their devices) and set its step."""
    state.model.load_state_dict(tree["params"])
    state.optimizer.load_state_dict(tree["opt_state"])
    state.step = int(tree["step"])
    return state


def _save(path: str, tree: Any) -> None:
    tmp = f"{path}.tmp"
    torch.save(state_tree(tree), tmp)
    os.replace(tmp, path)


def _same_structure(tree: Any, template: Any) -> bool:
    if isinstance(template, dict):
        return (isinstance(tree, dict) and set(tree) == set(template)
                and all(_same_structure(tree[k], template[k]) for k in template))
    if isinstance(template, (list, tuple)):
        return (isinstance(tree, (list, tuple)) and len(tree) == len(template)
                and all(_same_structure(a, b) for a, b in zip(tree, template)))
    if isinstance(template, torch.Tensor):
        return isinstance(tree, torch.Tensor) and tree.shape == template.shape
    return not isinstance(tree, (dict, list, tuple, torch.Tensor))


def save_pytree(path: str, tree: Any) -> None:
    """Save one tree (a ``TrainState`` as its checkpoint dict)."""
    _save(os.path.abspath(path), tree)


def load_pytree(path: str, template: Any = None) -> Any:
    """Load a tree saved by :func:`save_pytree`, its tensors on the CPU.
    With ``template`` (a tree or a ``TrainState``), raises ``ValueError``
    unless the checkpoint has its structure: the same keys and the same
    tensor shapes."""
    tree = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    if template is not None and not _same_structure(tree, state_tree(template)):
        raise ValueError(f"{path}: the checkpoint's structure differs from the template's")
    return tree


def load_subtree(path: str, keys: str | list[str], template: Any = None) -> Any:
    """The subtree at ``keys`` (a '/'-separated path or a list of keys) of a
    checkpoint. The checkpoint may be larger than ``template`` (a full
    train state spliced for its ``params``): when it does not fit the
    template, it is loaded whole and the subtree taken from it."""
    if isinstance(keys, str):
        keys = keys.split("/")
    try:
        tree = load_pytree(path, template)
    except (ValueError, KeyError):
        tree = load_pytree(path)
    for k in keys:
        tree = tree[k]
    return tree


class CheckpointManager:
    """Best-k checkpoints on a monitored loss (lower is better): after each
    ``save`` the ``max_to_keep`` best steps are kept, as the JAX package's
    Orbax manager keeps them. One file per kept step,
    ``ckpt_<step>.pt``, and an index ``checkpoints.json`` of their losses,
    read back when the directory is opened again."""

    INDEX = "checkpoints.json"

    def __init__(self, directory: str, max_to_keep: int = 1):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        index = os.path.join(self.directory, self.INDEX)
        self._losses: dict[int, float] = {}
        if os.path.exists(index):
            with open(index) as f:
                self._losses = {int(k): v for k, v in json.load(f).items()}

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def _ranked(self) -> list[int]:
        """Kept steps, best first; on a tie the later step first, as Orbax
        keeps them."""
        return sorted(self._losses, key=lambda s: (self._losses[s], -s))

    def save(self, step: int, state: Any, monitored_loss: float) -> None:
        _save(self.path(step), state)
        self._losses[int(step)] = float(monitored_loss)
        for s in self._ranked()[self.max_to_keep:]:
            del self._losses[s]
            if os.path.exists(self.path(s)):
                os.remove(self.path(s))
        tmp = os.path.join(self.directory, self.INDEX + ".tmp")
        with open(tmp, "w") as f:
            json.dump({str(s): v for s, v in sorted(self._losses.items())}, f)
        os.replace(tmp, os.path.join(self.directory, self.INDEX))

    def restore(self, step: int | None = None, template: Any = None) -> dict:
        """The checkpoint of ``step`` (by default the best), tensors on the
        CPU; ``template`` as :func:`load_pytree`."""
        if step is None:
            step = self.best_step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return load_pytree(self.path(step), template)

    @property
    def best_step(self) -> int | None:
        ranked = self._ranked()
        return ranked[0] if ranked else None

    @property
    def latest_step(self) -> int | None:
        return max(self._losses) if self._losses else None
