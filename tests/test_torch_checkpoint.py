"""The port's checkpoints (``ocflow_torch.utils.checkpoint``, ``torch.save``
in place of Orbax): the four cases of ``tests/test_checkpoint.py`` on the
port's contract, and round trips of a FlowNetCV with its Adam state, equal
bit for bit (no tolerance: the same bytes are written and read)."""

import json

import numpy as np
import pytest
import torch

from ocflow_torch.models import FlowNetCV
from ocflow_torch.train import create_train_state, make_unsupervised_flow_step
from ocflow_torch.utils import checkpoint as ckpt
from test_torch_ops import share_cores  # noqa: F401  (autouse)


def _state(seed=0, lr=1e-3):
    model = FlowNetCV(generator=torch.Generator().manual_seed(seed))
    return create_train_state(model, lr, device="cpu")


def _stepped_state(steps=2):
    """A train state after ``steps`` Adam steps at 2x64x128, so the
    optimizer has moments and a step count."""
    state = _state(lr=1e-4)
    step, _ = make_unsupervised_flow_step({"model": "pwc", "fast_forward": "both"})
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (2, 64, 128, 6))
                         .astype(np.float32))
    for _ in range(steps):
        step(state, {"images": x})
    return state


def _assert_state_equal(a, b):
    assert a.step == b.step
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(), b.model.state_dict().items(),
                                  strict=True):
        assert ka == kb and torch.equal(va, vb), ka
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys()
    for i, s in oa["state"].items():
        for k, v in s.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)


def test_save_load_pytree(tmp_path):
    w = torch.from_numpy(np.random.default_rng(42).standard_normal((4, 4)).astype(np.float32))
    tree = {"params": {"w": w}, "step": 3}
    path = str(tmp_path / "ck")
    ckpt.save_pytree(path, tree)
    back = ckpt.load_pytree(path, tree)
    assert torch.equal(back["params"]["w"], w)
    assert back["step"] == 3


def test_load_subtree_for_staged_training(tmp_path):
    """A later stage splices an earlier stage's flow parameters out of its
    train-state checkpoint."""
    state = _state()
    path = str(tmp_path / "stage1")
    ckpt.save_pytree(path, state)
    params = ckpt.load_subtree(path, "params", template=state)
    for k, v in state.model.state_dict().items():
        assert torch.equal(params[k], v), k
    fresh = FlowNetCV()
    fresh.load_state_dict(params)
    assert torch.equal(fresh.state_dict()["conv1a.0.weight"],
                       state.model.state_dict()["conv1a.0.weight"])


def test_checkpoint_manager_best(tmp_path):
    """Best-k on the monitored loss (min, one kept): the best step stays,
    ``restore()`` takes it; reopening the directory reads the index back."""
    state = _state()
    directory = str(tmp_path / "mgr")
    mgr = ckpt.CheckpointManager(directory, max_to_keep=1)
    for step, loss in ((0, 1.0), (1, 0.5), (2, 0.9)):
        state.step = step
        mgr.save(step, state, monitored_loss=loss)
    assert mgr.best_step == 1 and mgr.latest_step == 1
    assert sorted(p.name for p in (tmp_path / "mgr").iterdir()) == [
        "checkpoints.json", "ckpt_1.pt"]
    assert mgr.restore(template=state)["step"] == 1
    again = ckpt.CheckpointManager(directory, max_to_keep=1)
    assert again.best_step == 1
    state.step = 3
    again.save(3, state, monitored_loss=0.2)
    assert again.best_step == 3 and again.restore()["step"] == 3
    assert json.loads((tmp_path / "mgr" / "checkpoints.json").read_text()) == {"3": 0.2}


def test_checkpoint_manager_keeps_k_best(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), max_to_keep=2)
    for step, loss in ((0, 0.9), (1, 0.3), (2, 0.7), (3, 0.1)):
        mgr.save(step, {"step": step}, loss)
    assert mgr.best_step == 3 and mgr.latest_step == 3
    assert sorted(p.name for p in tmp_path.glob("ckpt_*.pt")) == ["ckpt_1.pt", "ckpt_3.pt"]
    assert mgr.restore(1)["step"] == 1
    # on a tie the later step stays, as the JAX package's Orbax manager keeps it
    ties = ckpt.CheckpointManager(str(tmp_path / "ties"), max_to_keep=2)
    for step, loss in ((0, 0.5), (1, 0.5), (2, 0.7), (3, 0.5)):
        ties.save(step, {"step": step}, loss)
    assert ties.best_step == 3 and sorted(ties._losses) == [1, 3]
    with pytest.raises(FileNotFoundError):
        ckpt.CheckpointManager(str(tmp_path / "empty")).restore()


def test_load_subtree_from_larger_checkpoint(tmp_path):
    """A checkpoint larger than the template (a full train state spliced
    for its params) still gives its params subtree: the template's
    structure check fails and the whole checkpoint is read."""
    w = torch.from_numpy(np.random.default_rng(42).standard_normal((4, 4)).astype(np.float32))
    full = {"step": 7, "params": {"Conv_0": {"kernel": w}},
            "opt_state": {"m": torch.zeros(4)}}
    path = str(tmp_path / "gan_gen")
    ckpt.save_pytree(path, full)
    template = {"params": {"Conv_0": {"kernel": torch.zeros_like(w)}}}
    with pytest.raises(ValueError):
        ckpt.load_pytree(path, template)
    params = ckpt.load_subtree(path, "params", template=template)
    assert torch.equal(params["Conv_0"]["kernel"], w)
    assert torch.equal(ckpt.load_subtree(path, ["params", "Conv_0", "kernel"]), w)


def test_train_state_round_trip_bit_for_bit(tmp_path):
    """FlowNetCV and Adam after two steps -> ``CheckpointManager.save`` ->
    ``restore`` into a fresh model and optimizer: parameters, moments, step
    counts and hyperparameters equal bit for bit; the restored state's next
    step equals the original's next step bit for bit too."""
    state = _stepped_state()
    mgr = ckpt.CheckpointManager(str(tmp_path / "ck"))
    mgr.save(0, state, monitored_loss=0.0)
    tree = mgr.restore()
    assert set(tree) == {"step", "params", "opt_state"}
    fresh = ckpt.load_state(_state(seed=5, lr=0.5), tree)
    _assert_state_equal(fresh, state)

    step, _ = make_unsupervised_flow_step({"model": "pwc", "fast_forward": "both"})
    x = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (2, 64, 128, 6))
                         .astype(np.float32))
    step(state, {"images": x})
    step(fresh, {"images": x})
    _assert_state_equal(fresh, state)
