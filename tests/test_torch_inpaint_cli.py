"""The three inpainting CLIs of the port on the CPU at 64x128.

- ``python -m ocflow_torch.train`` with ``network_type: inpainting`` on a
  mini Sintel tree with flow and occlusion (``MpiSintelFlowOccClean``): the
  CSV (a train row per step, a val row per epoch), the best checkpoint, the
  test metrics; with ``find_best_lr`` the range test runs first.
- ``python -m ocflow_torch.train_unsupervised`` with ``network_type:
  inpainting``, ``model: simple`` on ``SyntheticInpainting``: the stage
  step's rows and the ``inpaint`` panel (4 rows of 64x128), equal to the
  panel of the stepped net; the VGG loss (with the GAN too) and the
  two-stage pipelines on the same config. The gated generators and the GAN
  run (``tests/test_torch_gan_cli.py``).
- ``python -m ocflow_torch.evaluate --task inpainting --model simple`` on
  ``SyntheticInpainting`` and ``MpiSintelCleanInpainting``: PSNR and SSIM
  within 1e-5 relative of the JAX package's ``calculate_psnr`` /
  ``calculate_ssim`` over the JAX datasets' batches with the same weights
  (the port's seeded net through ``convert_inpainting_net``); without
  ``--device`` it wants CUDA.
"""

import json

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocflow_torch import evaluate as tevaluate
from ocflow_torch import train_unsupervised as ucli
from ocflow_torch.models import load_model
from ocflow_torch.train import __main__ as scli
from ocflow_torch.train import config as tconfig
from ocflow_torch.train.loop import make_loaders
from ocflow_torch.train.state import create_train_state
from ocflow_torch.utils import checkpoint as tckpt
from ocflow_tpu import data as jdata
from ocflow_tpu import metrics as jmetrics
from ocflow_tpu.models import inpainting_net as jinp
from ocflow_tpu.models import torch_convert as tc
from test_data import make_mini_sintel
from test_torch_cli import _read_csv
from test_torch_ops import share_cores  # noqa: F401  (autouse)

REL = 1e-5


@pytest.fixture(scope="module")
def sintel(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sintel"))
    make_mini_sintel(root, n_scenes=2, n_frames=6)  # 10 pairs: 8 / 1 / 1
    return root


def _config(tmp_path, name, **over):
    lines = {"network_type": "inpainting", "model": "simple", "image_size": "[64, 128]",
             "batch_size": 2, "num_workers": 0, "max_epochs": 1, "learning_rate": "1.0e-3",
             "log_every_n_steps": 1, "log_image_every_epoch": 1, "seed": 3,
             **{k: str(tmp_path / name / v) for k, v in (
                 ("metrics_csv", "metrics.csv"), ("log_dir", "tb"),
                 ("checkpoint_dir", "ckpt"))}, "result_dir": str(tmp_path / name), **over}
    path = tmp_path / f"{name}.yaml"
    path.write_text("".join(f"{k}: {v}\n" for k, v in lines.items()))
    return str(path)


def test_supervised_cli_trains_inpainting(tmp_path, sintel, capsys):
    cfg = _config(tmp_path, "sup", dataset_name="MpiSintelFlowOccClean", root=sintel)
    results = scli.main(["--config", cfg, "--device", "cpu"])
    assert set(results) == {"loss"} and np.isfinite(results["loss"]) and results["loss"] > 0
    assert "test: {'loss': " in capsys.readouterr().out
    rows = _read_csv(tmp_path / "sup" / "metrics.csv")
    assert [r["phase"] for r in rows] == ["train"] * 4 + ["val"]
    manager = tckpt.CheckpointManager(str(tmp_path / "sup" / "ckpt"))
    assert manager.restore()["step"] == 4
    model = load_model("inpainting", "simple", manager.path(manager.best_step), "cpu")
    assert not model.training


def test_supervised_cli_finds_the_learning_rate_first(tmp_path, sintel, capsys):
    cfg = _config(tmp_path, "lr", dataset_name="MpiSintelFlowOccClean", root=sintel,
                  find_best_lr="true")
    scli.main(["--config", cfg, "--device", "cpu"])
    (line,) = [ln for ln in capsys.readouterr().out.splitlines() if "find_best_lr" in ln]
    assert np.isfinite(float(line.split(":")[1]))


def test_unsupervised_cli_trains_the_stage_step(tmp_path):
    cfg = _config(tmp_path, "stage", dataset_name="SyntheticInpainting", dataset_size=10,
                  occlusion_ratio="0.4")
    results = ucli.main(["--config", cfg, "--device", "cpu"])
    assert set(results) == {"loss", "rhole", "runhole"}
    assert all(np.isfinite(v) for v in results.values())
    rows = _read_csv(tmp_path / "stage" / "metrics.csv")
    assert [r["phase"] for r in rows] == ["train"] * 4 + ["val"]
    panel = imageio.imread(tmp_path / "stage" / "val_0" / "inpaint.png")
    assert panel.shape == (256, 128, 3)
    # the panel of the best checkpoint's net on the first val sample
    _, val, _ = make_loaders(tconfig.load_config(cfg), "cpu")
    manager = tckpt.CheckpointManager(str(tmp_path / "stage" / "ckpt"))
    model = load_model("inpainting", "simple", manager.path(manager.best_step), "cpu")
    state = create_train_state(model, 0.0, device="cpu")
    again = ucli.inpaint_viz_fn(state, next(iter(val)))["inpaint"]
    assert np.array_equal(panel, again)


@pytest.mark.parametrize("over,metrics", [
    ({"loss_type": "vgg"}, {"loss", "vgg_loss", "reconst_loss"}),
    ({"adversarial_loss": "true", "loss_type": "vgg"}, {"loss", "rhole", "runhole"}),
    ({"network_type": "twostage", "dataset_name": "SyntheticFlowWarp",
      "inpainting_stage": "simple"},
     {"loss", "photometric", "photometric_occluded", "reconst", "smoothness", "pixelwise"})])
def test_unsupervised_cli_runs_what_was_queued(tmp_path, over, metrics):
    """The three configs the CLI refused until the VGG loss and the
    two-stage pipelines were ported, on the same tiny config: the stage step
    and the GAN step with ``loss_type: vgg`` (the seeded VGG16), and
    ``network_type: twostage`` (on a flow dataset) train and print their
    test metrics (the GAN run's are its pixel-wise stage eval's)."""
    cfg = _config(tmp_path, "queued", **{"dataset_name": "SyntheticInpainting", "dataset_size": 10,
                                         **over})
    results = ucli.main(["--config", cfg, "--device", "cpu"])
    assert set(results) == metrics and all(np.isfinite(v) for v in results.values())


def _jax_metrics(dataset, batch_size):
    """The JAX package's PSNR and SSIM of the port's seeded net (through
    ``convert_inpainting_net``) over the JAX dataset's batches."""
    model = load_model("inpainting", "simple", "", "cpu")
    variables = tc.convert_inpainting_net({k: v.clone() for k, v in model.state_dict().items()})
    apply = jax.jit(jinp.InpaintingNet().apply)
    batches = list(jdata.DataLoader(dataset, batch_size, drop_last=False))
    fn = lambda i, m: apply(variables, jnp.asarray(i), jnp.asarray(m))  # noqa: E731
    return jmetrics.calculate_psnr(fn, batches), jmetrics.calculate_ssim(fn, batches)


@pytest.mark.parametrize("name", ["SyntheticInpainting", "MpiSintelCleanInpainting"])
def test_evaluate_inpainting_matches_jax(name, sintel, capsys):
    args = ["--device", "cpu", "--task", "inpainting", "--model", "simple", "--dataset", name,
            "--batch_size", "3"]
    if name == "SyntheticInpainting":
        args += ["--dataset_size", "5", "--image_size", "64", "128"]
        ref_ds = jdata.build_dataset(name, size=5, image_size=(64, 128))
    else:
        args += ["--root", sintel]
        ref_ds = jdata.build_dataset(name, root=sintel)
    results = tevaluate.main(args)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == results
    psnr, ssim = _jax_metrics(ref_ds, 3)
    assert abs(results["psnr"] - psnr) <= REL * abs(psnr)
    assert abs(results["ssim"] - ssim) <= REL * abs(ssim)
    assert results["ssim"] <= 1.0


def test_evaluate_inpainting_runs_on_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tevaluate.main(["--task", "inpainting", "--model", "simple", "--dataset",
                        "SyntheticInpainting", "--dataset_size", "2"])
