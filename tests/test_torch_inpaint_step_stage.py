"""One inpainting stage train step of the port (``loss_type: pixel-wise``)
against ``ocflow_tpu.train.steps_inpainting.make_inpainting_stage_step``, on
the CPU at 2x64x128: InpaintingNet completes the batch's ``image`` under
its ``occ`` and ``recon_loss`` (hole and un-hole L1 over each image's mask
share) is the loss; metrics ``loss``, ``rhole``, ``runhole``. Bounds and
harness as ``tests/test_torch_inpaint_step_sup.py`` states. ``loss_type:
vgg`` takes the perceptual loss on the VGG16 it is given."""

import pytest

from ocflow_torch.train import make_inpainting_stage_step
from test_torch_inpaint_step_sup import check_adam, check_step
from test_torch_ops import share_cores  # noqa: F401  (autouse)


@pytest.mark.parametrize("fp64", [True, False], ids=["fp64", "fp32"])
def test_inpainting_stage_step_matches_jax(fp64):
    check_step("stage", fp64)


def test_inpainting_stage_step_adam_matches_optax():
    check_adam("stage")


def test_stage_step_takes_the_vgg_loss():
    """``loss_type: vgg`` needs the VGG16, and with it trains: the loss is
    the perceptual loss plus ``reconst_weight`` times ``recon_loss``
    (``tests/test_torch_perceptual.py`` holds it against the JAX step)."""
    import torch

    from ocflow_torch.losses.perceptual import init_vgg16
    from ocflow_torch.models import InpaintingNet
    from ocflow_torch.train import create_train_state
    from test_torch_inpaint_step_sup import make_batch

    with pytest.raises(ValueError, match="vgg"):
        make_inpainting_stage_step({"loss_type": "vgg"})
    train_step, _ = make_inpainting_stage_step({"loss_type": "vgg", "reconst_weight": 0.5},
                                               init_vgg16())
    state = create_train_state(InpaintingNet(generator=torch.Generator().manual_seed(0)), 1e-3,
                               device="cpu")
    _, m = train_step(state, {k: torch.from_numpy(v) for k, v in make_batch("stage").items()})
    assert set(m) == {"loss", "vgg_loss", "reconst_loss"}
    assert abs(m["loss"] - m["vgg_loss"] - 0.5 * m["reconst_loss"]).item() <= 1e-6
