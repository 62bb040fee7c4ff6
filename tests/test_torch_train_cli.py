"""The port's supervised trainer CLI, ``python -m ocflow_torch.train``, on
the CPU: each ``network_type`` (``flow`` on SimpleFlowNet, ``occ`` on
OcclusionNetC, ``flow-occ`` on FlowOccNetCV) on a tiny config (64x128, 20
SyntheticFlow samples, B=4) through ``--device cpu``; ``find_best_lr``; the
gated-conv inpainting generators built (refused until ROADMAP A10.3 was
ported); no silent CPU fallback
without ``--device``. The run against the repository's JAX ``train.py``:
``tests/test_torch_train_cli_jax.py``.
"""

import csv
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from ocflow_torch.models import SimpleFlowNet
from ocflow_torch.train import __main__ as cli
from ocflow_torch.utils import checkpoint as tckpt
from test_torch_ops import share_cores  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
MODELS = {"flow": "simple", "occ": "occnetc", "flow-occ": "pwoc"}


def _config(tmp_path, name="run", **over):
    lines = {"network_type": "flow", "model": "simple", "dataset_name": "SyntheticFlow",
             "dataset_size": 20, "image_size": "[64, 128]", "batch_size": 4,
             "num_workers": 0, "max_epochs": 2, "patience": 60, "learning_rate": "1.0e-3",
             "log_every_n_steps": 1, "seed": 42,
             **{k: str(tmp_path / name / v) for k, v in (
                 ("metrics_csv", "metrics.csv"), ("log_dir", "tb"),
                 ("checkpoint_dir", "ckpt"))}, **over}
    path = tmp_path / f"{name}.yaml"
    path.write_text("".join(f"{k}: {v}\n" for k, v in lines.items()))
    return str(path)


def _rows(tmp_path, name="run"):
    with open(tmp_path / name / "metrics.csv") as f:
        return list(csv.DictReader(f))


def test_cli_trains_flow_as_a_process(tmp_path):
    """``python -m ocflow_torch.train --device cpu``: exits 0, prints the
    test metrics, writes the CSV (a train row per step, a val row per
    epoch) and the best checkpoint, whose BatchNorm statistics moved."""
    env = {**os.environ, "OMP_NUM_THREADS": str(torch.get_num_threads())}
    out = subprocess.run([sys.executable, "-m", "ocflow_torch.train", "--config",
                          _config(tmp_path, max_epochs=3), "--max_epochs", "2",
                          "--device", "cpu"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert re.search(r"^test: \{'loss': ", out.stdout, re.M), out.stdout
    # 16 / 2 / 2 pairs: 4 steps of 4 a epoch
    assert [r["phase"] for r in _rows(tmp_path)] == ["train"] * 4 + ["val"] + \
        ["train"] * 4 + ["val"]
    tree = tckpt.CheckpointManager(str(tmp_path / "run" / "ckpt")).restore()
    SimpleFlowNet().load_state_dict(tree["params"])
    assert float(tree["params"]["down1.bn1.running_var"].sub(1).abs().max()) > 0


@pytest.mark.parametrize("network_type", ["occ", "flow-occ"])
def test_cli_trains_each_network_type(tmp_path, network_type):
    results = cli.main(["--config", _config(tmp_path, network_type=network_type,
                                            model=MODELS[network_type], max_epochs=1),
                        "--device", "cpu"])
    want = {"loss"} | ({"flow_loss", "occ_loss"} if network_type == "flow-occ" else set())
    assert set(results) == want and all(math.isfinite(v) for v in results.values())
    assert [r["phase"] for r in _rows(tmp_path)] == ["train"] * 4 + ["val"]


def test_cli_with_find_best_lr_trains_at_the_suggestion(tmp_path, capsys, monkeypatch):
    """``find_best_lr``: the range test's suggestion is printed and the
    fit starts from fresh weights at it."""
    seen = []
    make = cli.create_train_state

    def spy(model, learning_rate, device=None):
        seen.append(learning_rate)
        return make(model, learning_rate, device=device)

    monkeypatch.setattr(cli, "create_train_state", spy)
    cli.main(["--config", _config(tmp_path, find_best_lr="true", max_epochs=1),
              "--device", "cpu"])
    (line,) = [ln for ln in capsys.readouterr().out.splitlines() if "find_best_lr" in ln]
    suggested = float(line.split(":")[1])
    assert seen[0] == 1e-7 and seen[-1] == suggested and len(seen) == 2


def test_cli_refuses_inpainting_naming_a10(tmp_path):
    """``network_type: inpainting`` trains every generator of the registry
    (``simple``: tests/test_torch_inpaint_cli.py): the gated-conv ones,
    refused naming ROADMAP A10.3 until A10.3 was ported, are built seeded
    from the config (their training run: tests/test_torch_gan_cli.py); a key
    the family lacks raises, listing the family's keys."""
    from ocflow_torch.models import InpaintSANet, InpaintSANetOrg
    from ocflow_torch.train.config import load_config

    for model, cls in (("gated", InpaintSANet), ("gated_org", InpaintSANetOrg)):
        cfg = load_config(_config(tmp_path, network_type="inpainting", model=model))
        a, b = cli.build_net(cfg), cli.build_net(cfg)
        assert type(a) is cls
        assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    with pytest.raises(ValueError, match="gated_org"):
        cli.main(["--config", _config(tmp_path, network_type="inpainting", model="vgg"),
                  "--device", "cpu"])


def test_cli_runs_on_cuda_unless_told(tmp_path):
    """Without ``--device`` the CLI wants CUDA, and raises without it (no
    silent CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--config", _config(tmp_path)])
