"""One inpainting stage train step of the port (``loss_type: pixel-wise``)
against ``ocflow_tpu.train.steps_inpainting.make_inpainting_stage_step``, on
the CPU at 2x64x128: InpaintingNet completes the batch's ``image`` under
its ``occ`` and ``recon_loss`` (hole and un-hole L1 over each image's mask
share) is the loss; metrics ``loss``, ``rhole``, ``runhole``. Bounds and
harness as ``tests/test_torch_inpaint_step_sup.py`` states. ``loss_type:
vgg`` raises, naming ROADMAP A10.5."""

import pytest

from ocflow_torch.train import make_inpainting_stage_step
from test_torch_inpaint_step_sup import check_adam, check_step
from test_torch_ops import share_cores  # noqa: F401  (autouse)


@pytest.mark.parametrize("fp64", [True, False], ids=["fp64", "fp32"])
def test_inpainting_stage_step_matches_jax(fp64):
    check_step("stage", fp64)


def test_inpainting_stage_step_adam_matches_optax():
    check_adam("stage")


def test_stage_step_refuses_the_vgg_loss():
    with pytest.raises(NotImplementedError, match="A10.5"):
        make_inpainting_stage_step({"loss_type": "vgg"})
