"""The trainer CLIs over 2 gloo ranks on the CPU
(``tests/torch_parallel_ranks.py:cli_rank``; the group joined before
``main``, as ``torchrun`` would have it join from its environment):
``ocflow_torch.train_unsupervised`` (FlowNetCV, occlusion-aware, 12
samples at 64x128, a global batch of 4, 1 epoch) and the supervised
``python -m ocflow_torch.train`` (FlowNetCV, MSE flow) each train on the
ranks' blocks. Held: every rank returns the same test metrics; rank 0 alone
writes the CSV (one header, the rows of one run), the TensorBoard events
and the checkpoint; the replicas end equal (``fit`` raises otherwise).
"""

import csv

import pytest
import torch

import torch_parallel_ranks as ranks
from ocflow_torch.tools.dryrun_multigpu import spawn
from test_torch_ops import share_cores  # noqa: F401  (autouse)

WORLD = 2


def _config(tmp, name, **over):
    lines = {"network_type": "flow", "model": "pwc", "dataset_name": "SyntheticFlowWarp",
             "dataset_size": 12, "device_cache": "true", "image_size": "[64, 128]",
             "batch_size": 4, "num_workers": 0, "max_epochs": 1,
             "learning_rate": "1.0e-4", "photo_weight": "4.0", "smooth1_weight": "0.5",
             "smooth2_weight": "0.0", "occ_aware": "true", "occ_method": "range_map",
             "compute_dtype": "float32", "fast_forward": "both", "log_every_n_steps": 1,
             "log_image_every_epoch": 1, "metrics_csv": str(tmp / name / "metrics.csv"),
             "log_dir": str(tmp / name / "tb"), "checkpoint_dir": str(tmp / name / "ckpt"),
             "result_dir": str(tmp / name), **over}
    path = tmp / f"{name}.yaml"
    path.write_text("".join(f"{k}: {v}\n" for k, v in lines.items()))
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    configs = {"unsupervised": _config(tmp, "unsupervised"),
               "supervised": _config(tmp, "supervised")}
    spawn(ranks.cli_rank, WORLD, str(tmp), configs, timeout=300)
    per_rank = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return tmp, per_rank


@pytest.mark.parametrize("name", ["unsupervised", "supervised"])
def test_ranks_return_the_same_test_metrics(runs, name):
    _, per_rank = runs
    first = per_rank[0]["results"][name]
    assert first and "loss" in first
    assert all(r["results"][name] == first for r in per_rank[1:])


@pytest.mark.parametrize("name", ["unsupervised", "supervised"])
def test_rank_0_alone_writes(runs, name):
    tmp, _ = runs
    with open(tmp / name / "metrics.csv") as f:
        lines = f.read().splitlines()
    assert sum(line.startswith("phase,") for line in lines) == 1
    # 9 train samples: 2 steps of 4, each logged, then 1 val row
    assert [r["phase"] for r in csv.DictReader(lines)] == ["train", "train", "val"]
    assert len(list((tmp / name / "tb").glob("events.*"))) == 1
    assert len(list((tmp / name / "ckpt").iterdir())) >= 1
