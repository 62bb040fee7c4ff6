"""The port's trainer CLI, ``python -m ocflow_torch.train_unsupervised``, on
the CPU: a run on a tiny config (64x128, 20 samples) through ``--device
cpu``, the two-stage pipeline on it, its refusal of what the JAX package
cannot train either, and no silent CPU fallback without ``--device``."""

import csv
import os
import re
import subprocess
import sys
from pathlib import Path

import imageio.v2 as imageio
import pytest
import torch

from ocflow_torch.models import FlowNetCV
from ocflow_torch.train_unsupervised import main as cli_main
from ocflow_torch.utils import checkpoint as tckpt
from test_torch_ops import share_cores  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]


def _read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _tiny_config(tmp_path, **over):
    lines = {"network_type": "flow", "model": "pwc", "dataset_name": "SyntheticFlowWarp",
             "dataset_size": 20, "device_cache": "true", "image_size": "[64, 128]",
             "batch_size": 4, "num_workers": 1, "max_epochs": 1,
             "learning_rate": "1.0e-4", "photo_weight": "4.0", "smooth1_weight": "0.5",
             "smooth2_weight": "0.0", "occ_aware": "true", "occ_method": "range_map",
             "compute_dtype": "float32", "fast_forward": "both", "log_every_n_steps": 2,
             "log_image_every_epoch": 1, **{k: str(tmp_path / "run" / v) for k, v in (
                 ("metrics_csv", "metrics.csv"), ("log_dir", "tb"),
                 ("checkpoint_dir", "ckpt"))}, "result_dir": str(tmp_path / "run"), **over}
    path = tmp_path / "tiny.yaml"
    path.write_text("# a tiny longrun\n" + "".join(
        f"{k}: {v}   # {k}\n" for k, v in lines.items()))
    return str(path)


def test_cli_trains_on_the_cpu(tmp_path):
    """``python -m ocflow_torch.train_unsupervised --device cpu``: exits 0,
    prints the test metrics, writes the CSV (a train row every second of its
    4 steps, 1 val row), the two panels and the best checkpoint."""
    # the run's threads: this worker's share of the cores (share_cores)
    env = {**os.environ, "OMP_NUM_THREADS": str(torch.get_num_threads())}
    out = subprocess.run(
        [sys.executable, "-m", "ocflow_torch.train_unsupervised",
         "--config", _tiny_config(tmp_path, max_epochs=3), "--max_epochs", "1",
         "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert re.search(r"^test: \{'loss': ", out.stdout, re.M), out.stdout
    rows = _read_csv(tmp_path / "run" / "metrics.csv")
    assert [r["phase"] for r in rows] == ["train", "train", "val"]
    assert sorted(p.name for p in (tmp_path / "run" / "val_0").iterdir()) == \
        ["flow.png", "warp.png"]
    assert imageio.imread(tmp_path / "run" / "val_0" / "warp.png").shape == (256, 128, 3)
    tree = tckpt.CheckpointManager(str(tmp_path / "run" / "ckpt")).restore()
    assert tree["step"] == 4
    FlowNetCV().load_state_dict(tree["params"])


@pytest.mark.parametrize("over,match", [({"model": "eflownet"}, "dropout rng")])
def test_cli_refuses_what_the_port_cannot_train(tmp_path, over, match):
    with pytest.raises(NotImplementedError, match=match):
        cli_main(["--config", _tiny_config(tmp_path, **over), "--device", "cpu"])


def test_cli_trains_the_two_stage_pipeline(tmp_path):
    """``network_type: twostage`` on the same tiny config (refused until
    the two-stage pipelines were ported): the GC pipeline with its defaults
    (ground-truth flow, the gated inpainter, gated until epoch 23) trains
    its 4 steps and prints the GC step's test metrics."""
    results = cli_main(["--config", _tiny_config(tmp_path, network_type="twostage"),
                        "--device", "cpu"])
    assert set(results) == {"loss", "photometric", "photometric_occluded", "reconst",
                            "smoothness", "pixelwise"}
    rows = _read_csv(tmp_path / "run" / "metrics.csv")
    assert [r["phase"] for r in rows] == ["train", "train", "val"]


def test_cli_runs_on_cuda_unless_told(tmp_path):
    """Without ``--device`` the CLI wants CUDA, and raises without it (no
    silent CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["--config", _tiny_config(tmp_path)])


def test_cli_trains_on_flying_chairs2_files(tmp_path):
    """A config naming a file-backed dataset and its ``root`` (the JAX
    package's unsupervised set-up, FlyingChairs2): ``make_loaders`` reads
    the files, the device cache keeps them, ``fit`` trains, and the test
    metrics carry the occlusion masks' BCE."""
    import numpy as np

    from ocflow_torch.data import write_flo
    from ocflow_torch.utils.png import write_png

    root = tmp_path / "chairs2"
    root.mkdir()
    rng = np.random.default_rng(0)
    for i in range(10):
        for k in (1, 2):
            write_png(str(root / f"{i:05d}-img_{k}.png"),
                      rng.integers(0, 256, (64, 128, 3), dtype=np.uint8))
        write_flo(str(root / f"{i:05d}-flow_01.flo"),
                  rng.standard_normal((64, 128, 2)).astype(np.float32))
        write_png(str(root / f"{i:05d}-occ_01.png"),
                  (rng.uniform(size=(64, 128)) > 0.5).astype(np.uint8) * 255)
    config = _tiny_config(tmp_path, dataset_name="FlyingChairs2", root=str(root),
                          dataset_size=0, image_size="null")
    results = cli_main(["--config", config, "--device", "cpu"])
    assert {"loss", "epe", "occ_error"} <= set(results)
    rows = _read_csv(tmp_path / "run" / "metrics.csv")
    # 8 / 1 / 1 pairs: 2 steps of 4, a train row every second step, 1 val row
    assert [r["phase"] for r in rows] == ["train", "val"]
