"""The gated-conv GAN through the port's CLIs on the CPU.

- ``python -m ocflow_torch.train_unsupervised`` on a copy of
  ``configs/inpainting_gan_fullres.yaml`` (``model: gated``, ``remat:
  true``, ``adversarial_loss: true``) cut for the CPU: ``image_size [64,
  128]`` (at 32x64 the discriminators' fifth map has no row, and the hinge
  losses would be means over nothing), ``dataset_size 10`` (8 / 1 / 1; at 8
  the validation split is empty and no checkpoint is written),
  ``max_epochs 1``, ``num_workers 0``, the outputs in a temporary directory,
  ``--device cpu``. The CSV's rows carry the GAN step's metrics, the
  checkpoint is the ``(generator, discriminator)`` pair, the generator alone
  is exported to ``checkpoint_dir/generator``; ``python -m
  ocflow_torch.evaluate --task inpainting --model gated`` loads it (and the
  pair checkpoint) and prints finite PSNR and SSIM. The same with ``org:
  true`` (``gated_org``, plain towers), and the stage regime
  (``adversarial_loss: false``) on ``model: gated``.
- ``python -m ocflow_torch.train`` with ``network_type: inpainting, model:
  gated`` takes its steps on a mini Sintel tree.
"""

import math

import numpy as np
import pytest
import torch

from ocflow_torch import evaluate as tevaluate
from ocflow_torch import train_unsupervised as ucli
from ocflow_torch.models import InpaintSADiscriminatorOrg, InpaintSANetOrg
from ocflow_torch.train import __main__ as scli
from ocflow_torch.train import config as tconfig
from ocflow_torch.utils import checkpoint as tckpt
from test_torch_cli import _read_csv
from test_torch_inpaint_cli import sintel  # noqa: F401  (fixture)
from test_torch_ops import share_cores  # noqa: F401  (autouse)

# the cuts of configs/inpainting_gan_fullres.yaml for the CPU (module docstring)
CUTS = {"image_size": [64, 128], "dataset_size": 10, "max_epochs": 1, "num_workers": 0,
        "log_every_n_steps": 1}
GAN_METRICS = {"whole_loss", "d_loss", "g_loss", "content_loss", "occluded", "non_occluded"}


def _gan_config(tmp_path, name, **over):
    with open("configs/inpainting_gan_fullres.yaml") as f:
        raw = tconfig.parse_flat_yaml(f.read())
    raw.update(CUTS, **over)
    raw.update({k: str(tmp_path / name / v) for k, v in (
        ("metrics_csv", "metrics.csv"), ("log_dir", "tb"), ("checkpoint_dir", "ckpt"),
        ("result_dir", "."))})
    path = tmp_path / f"{name}.yaml"
    path.write_text("".join(f"{k}: {str(v).lower() if isinstance(v, bool) else v}\n"
                            for k, v in raw.items()))
    return str(path), raw


def _evaluate(key, checkpoint, capsys):
    capsys.readouterr()
    results = tevaluate.main(["--device", "cpu", "--task", "inpainting", "--model", key,
                              "--checkpoint", checkpoint, "--dataset", "SyntheticInpainting",
                              "--dataset_size", "4", "--image_size", "64", "128"])
    assert set(results) == {"psnr", "ssim"} and all(math.isfinite(v) for v in results.values())
    assert results["ssim"] <= 1.0
    assert '"psnr"' in capsys.readouterr().out
    return results


@pytest.mark.parametrize("org", [False, True], ids=["gated", "gated_org"])
def test_gan_cli_trains_and_exports_the_generator(tmp_path, capsys, org):
    path, raw = _gan_config(tmp_path, "gan", org=org)
    assert raw["adversarial_loss"] and raw["remat"] and raw["model"] == "gated"
    results = ucli.main(["--config", path, "--device", "cpu"])
    assert set(results) == {"loss", "rhole", "runhole"}
    assert all(math.isfinite(v) for v in results.values())
    out = capsys.readouterr().out
    assert "generator checkpoint:" in out and "fit: 4 steps of 2 pairs" in out
    rows = _read_csv(tmp_path / "gan" / "metrics.csv")
    assert [r["phase"] for r in rows] == ["train"] * 4 + ["val"]
    assert GAN_METRICS <= set(rows[0]) and all(
        math.isfinite(float(r[k])) for r in rows[:4] for k in GAN_METRICS)

    manager = tckpt.CheckpointManager(raw["checkpoint_dir"])
    pair = manager.restore()
    assert isinstance(pair, tuple) and len(pair) == 2
    gen, dis = pair
    assert gen["step"] == dis["step"] == 4
    assert any(k.endswith(".u") for k in dis["params"])
    assert any(k.endswith("running_mean") for k in gen["params"])
    # D at 4x the G learning rate
    assert dis["opt_state"]["param_groups"][0]["lr"] == 4 * gen["opt_state"]["param_groups"][0]["lr"]
    exported = tckpt.load_pytree(f"{raw['checkpoint_dir']}/generator")
    assert set(exported) == {"params"}
    assert all(torch.equal(v, gen["params"][k]) for k, v in exported["params"].items())
    if org:
        model = InpaintSANetOrg()
        model.load_state_dict(exported["params"])
        InpaintSADiscriminatorOrg().load_state_dict(dis["params"])

    key = "gated_org" if org else "gated"
    a = _evaluate(key, f"{raw['checkpoint_dir']}/generator", capsys)
    b = _evaluate(key, manager.path(manager.best_step), capsys)
    assert a == b


def test_stage_cli_trains_the_gated_generator(tmp_path):
    """``adversarial_loss: false`` on ``model: gated`` (remat on): the
    stage step's metrics, no discriminator, no ``generator`` export."""
    path, raw = _gan_config(tmp_path, "stage", adversarial_loss=False)
    results = ucli.main(["--config", path, "--device", "cpu"])
    assert set(results) == {"loss", "rhole", "runhole"}
    rows = _read_csv(tmp_path / "stage" / "metrics.csv")
    assert [r["phase"] for r in rows] == ["train"] * 4 + ["val"]
    best = tckpt.CheckpointManager(raw["checkpoint_dir"]).restore()
    assert isinstance(best, dict) and best["step"] == 4
    assert not (tmp_path / "stage" / "ckpt" / "generator").exists()


def test_supervised_cli_trains_the_gated_generator(tmp_path, sintel):  # noqa: F811
    lines = {"network_type": "inpainting", "model": "gated", "dataset_name":
             "MpiSintelFlowOccClean", "root": sintel, "image_size": "[64, 128]",
             "batch_size": 2, "num_workers": 0, "max_epochs": 1, "learning_rate": "1.0e-3",
             "log_every_n_steps": 1, "seed": 3,
             **{k: str(tmp_path / v) for k, v in (
                 ("metrics_csv", "metrics.csv"), ("log_dir", "tb"),
                 ("checkpoint_dir", "ckpt"))}}
    path = tmp_path / "sup.yaml"
    path.write_text("".join(f"{k}: {v}\n" for k, v in lines.items()))
    results = scli.main(["--config", str(path), "--device", "cpu"])
    assert set(results) == {"loss"} and np.isfinite(results["loss"]) and results["loss"] > 0
    rows = _read_csv(tmp_path / "metrics.csv")
    assert [r["phase"] for r in rows] == ["train"] * 4 + ["val"]
    assert tckpt.CheckpointManager(str(tmp_path / "ckpt")).restore()["step"] == 4
