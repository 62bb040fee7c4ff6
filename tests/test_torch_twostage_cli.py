"""``network_type: twostage`` through ``python -m
ocflow_torch.train_unsupervised --device cpu``, both branches, on tiny copies
of the shipped configs (64x128, 10-12 samples, batch 2, one epoch, outputs
in a temporary directory).

- ``with_gt_flow: true`` (``configs/two_stage_gc_fullres.yaml``: the gated
  generator with remat, ``unfreeze_epoch`` 1): the inpainter spliced from
  the generator that the GAN CLI exports (``using_pretrained_inpainting``,
  ``inpainting_root: .../generator``); the CSV's rows carry the GC step's
  metrics; the checkpoint restores both halves into a new
  ``nn.ModuleDict({'occ', 'inpaint'})`` and the gated optimizer; the
  inpainter in it equals the exported generator bit for bit (gated for the
  whole epoch) while the occlusion net moved; the ``pipeline`` panel equals
  the panel of the restored state.
- ``with_gt_flow: false`` (``configs/unsupervised.yaml``): the frozen
  SimpleFlowNet from ``flow_root`` (a port checkpoint, ``{"params":
  state_dict}``); the test metrics equal the eval step of the checkpointed
  occlusion net with that net (they would not with the seeded one). The
  reference's frozen inpainter feeds no number, and the port builds none.
"""

import imageio.v2 as imageio
import numpy as np
import torch
from torch import nn

from ocflow_torch import train_unsupervised as ucli
from ocflow_torch.bench import perturb_batchnorm
from ocflow_torch.models import SimpleFlowNet, SimpleOcclusionNet, registry
from ocflow_torch.train import TrainState, config as tconfig, loop
from ocflow_torch.train.state import create_train_state
from ocflow_torch.train.steps_two_stage import make_two_stage_gc_optimizer, make_two_stage_step
from ocflow_torch.utils import checkpoint as tckpt
from ocflow_torch.utils.checkpoint import save_pytree
from test_torch_cli import _read_csv
from test_torch_gan_cli import _gan_config
from test_torch_ops import share_cores  # noqa: F401  (autouse)

CUTS = {"image_size": [64, 128], "batch_size": 2, "num_workers": 0, "max_epochs": 1,
        "log_every_n_steps": 1, "log_image_every_epoch": 1}
GC_METRICS = {"loss", "photometric", "photometric_occluded", "reconst", "smoothness",
              "pixelwise"}


def _config(tmp_path, source, name, **over):
    with open(source) as f:
        raw = tconfig.parse_flat_yaml(f.read())
    raw.update(CUTS, **over)
    raw.update({k: str(tmp_path / name / v) for k, v in (
        ("metrics_csv", "metrics.csv"), ("log_dir", "tb"), ("checkpoint_dir", "ckpt"))},
        result_dir=str(tmp_path / name))
    path = tmp_path / f"{name}.yaml"
    path.write_text("".join(f"{k}: {_yaml(v)}\n" for k, v in raw.items()))
    return str(path)


def _yaml(v):
    """A scalar as the flat YAML of ``configs/`` reads it (a float with a
    dot and an exponent, as ``1.0e-5``)."""
    if isinstance(v, bool):
        return str(v).lower()
    return f"{v:.10e}" if isinstance(v, float) else v


def test_gc_branch_trains_splices_and_restores(tmp_path):
    gan_cfg, raw = _gan_config(tmp_path, "gan")
    ucli.main(["--config", gan_cfg, "--device", "cpu"])
    generator = f"{raw['checkpoint_dir']}/generator"
    exported = tckpt.load_pytree(generator)["params"]

    cfg = _config(tmp_path, "configs/two_stage_gc_fullres.yaml", "gc", dataset_size=12,
                  unfreeze_epoch=1, using_pretrained_inpainting=True, inpainting_root=generator)
    results = ucli.main(["--config", cfg, "--device", "cpu"])
    assert set(results) == GC_METRICS and all(np.isfinite(v) for v in results.values())
    rows = _read_csv(tmp_path / "gc" / "metrics.csv")
    assert [r["phase"] for r in rows] == ["train"] * 4 + ["val"]
    assert GC_METRICS <= set(rows[0])

    manager = tckpt.CheckpointManager(str(tmp_path / "gc" / "ckpt"))
    tree = manager.restore()
    pair = nn.ModuleDict({"occ": SimpleOcclusionNet(),
                          "inpaint": registry.build("inpainting", "gated", remat=True)})
    pair.load_state_dict(tree["params"])
    state = TrainState(pair, make_two_stage_gc_optimizer(pair, 1e-4, 1e-5, unfreeze_step=4))
    tckpt.load_state(state, tree)
    assert state.step == 4 and state.optimizer.param_groups[1]["updates"] == 4
    assert all(torch.equal(v, tree["params"][f"inpaint.{k}"]) for k, v in exported.items()
               if "running" not in k and "num_batches" not in k)
    seeded = SimpleOcclusionNet(generator=torch.Generator().manual_seed(42))
    assert not all(torch.equal(v, tree["params"][f"occ.{k}"])
                   for k, v in seeded.state_dict().items() if "num_batches" not in k)

    panel = imageio.imread(tmp_path / "gc" / "val_0" / "pipeline.png")
    assert panel.shape == (6 * 64, 128, 3)
    _, val, _ = loop.make_loaders(tconfig.load_config(cfg), "cpu")
    again = ucli.pipeline_viz_fn(state, next(iter(val)))["pipeline"]
    assert np.array_equal(panel, again)


def test_no_gt_flow_branch_loads_the_frozen_nets(tmp_path):
    nets = {}
    net = SimpleFlowNet(generator=torch.Generator().manual_seed(7))
    perturb_batchnorm(net, torch.Generator().manual_seed(107))
    save_pytree(str(tmp_path / "flow.pt"), {"params": net.state_dict()})
    nets["flow"] = net.eval()
    cfg = _config(tmp_path, "configs/unsupervised.yaml", "nogt", with_gt_flow=False,
                  dataset_size=12, flow_root=str(tmp_path / "flow.pt"))
    results = ucli.main(["--config", cfg, "--device", "cpu"])
    assert set(results) >= {"loss", "photometric", "reconst", "smoothness"}

    tree = tckpt.CheckpointManager(str(tmp_path / "nogt" / "ckpt")).restore()
    occ = SimpleOcclusionNet()
    occ.load_state_dict(tree["params"])
    state = create_train_state(occ, 0.0, device="cpu")
    c = tconfig.load_config(cfg)
    _, _, test = loop.make_loaders(c, "cpu")
    want = loop.evaluate(c, state, make_two_stage_step(c.as_hparams())[1], test, (nets,))
    assert set(want) == set(results)
    for k, v in want.items():
        assert abs(results[k] - v) <= 1e-6 * max(abs(v), 1e-12), k
