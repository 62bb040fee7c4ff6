"""``python -m ocflow_torch.evaluate --task inpainting --with_fid`` of the
port against the JAX CLI (``evaluate.py``) on the CPU: SyntheticInpainting,
4 samples at 64x128, batches of 2.

- ``--inception_weights F`` (the ``.npz`` of ``tests/test_torch_fid.py``,
  whose BatchNorm scales keep the features alive): PSNR, SSIM and FID within
  1e-5 relative of the JAX CLI's on the same weights (its
  ``init_inception``, whose eager flax ``init`` takes 43 s here, handed the
  ``.npz``'s variables), the JAX CLI's seeded inpainter (flax's init from
  ``PRNGKey(0)``) carried into the port as a checkpoint.
- ``--with_fid`` with neither refuses, in both CLIs (exit 2, naming
  ``--allow_random_fid``).
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ocflow_torch import evaluate as tevaluate
from ocflow_torch.models.convert import inpaintingnet_from_flax
from ocflow_torch.utils.checkpoint import save_pytree
from ocflow_tpu import data as jdata
from ocflow_tpu import metrics as jmetrics
from ocflow_tpu.models import inpainting_net as jinp
from test_torch_fid import weights  # noqa: F401  (fixture)
from test_torch_ops import share_cores  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
FID_REL = 1e-5
DATA = ["--task", "inpainting", "--model", "simple", "--dataset", "SyntheticInpainting",
        "--dataset_size", "4", "--image_size", "64", "128", "--batch_size", "2"]


def _jax_cli(argv, monkeypatch, capsys):
    sys.path.insert(0, str(REPO))
    try:
        import evaluate as jevaluate
    finally:
        sys.path.pop(0)
    monkeypatch.setattr(sys, "argv", ["evaluate.py", *argv])
    jevaluate.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_evaluate_with_fid_matches_the_jax_cli(weights, tmp_path, monkeypatch, capsys):
    path, jnet, variables = weights
    data = DATA
    # the JAX CLI's inpainter: flax's init from PRNGKey(0), as that CLI draws it
    sample = next(iter(jdata.DataLoader(jdata.build_dataset(
        "SyntheticInpainting", size=4, image_size=(64, 128)), 2)))
    jvars = jax.jit(jinp.InpaintingNet().init)(jax.random.PRNGKey(0),
                                                jnp.asarray(sample["image"][:1]),
                                                jnp.asarray(sample["occ"][:1]))
    ckpt = str(tmp_path / "inpaint.pt")
    save_pytree(ckpt, {"params": inpaintingnet_from_flax(
        jax.tree_util.tree_map(np.asarray, jvars))})
    monkeypatch.setattr(jmetrics, "init_inception", lambda rng, w=None: (jnet, variables))
    want = _jax_cli(data + ["--with_fid", "--inception_weights", path], monkeypatch, capsys)
    got = tevaluate.main(["--device", "cpu", "--checkpoint", ckpt, "--with_fid",
                          "--inception_weights", path] + data)
    capsys.readouterr()
    print(f"evaluate --with_fid: port {got}, JAX CLI {want}")
    assert set(got) == set(want) == {"psnr", "ssim", "fid"}
    for k, v in want.items():
        assert abs(got[k] - v) <= FID_REL * abs(v), k


def test_evaluate_with_fid_refuses_without_weights_or_the_flag(monkeypatch, capsys):
    for cli in (lambda a: tevaluate.main(["--device", "cpu"] + a),
                lambda a: _jax_cli(a, monkeypatch, capsys)):
        with pytest.raises(SystemExit) as e:
            cli(DATA + ["--with_fid"])
        assert e.value.code == 2
        assert "--allow_random_fid" in capsys.readouterr().err
