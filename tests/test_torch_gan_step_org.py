"""One SN-PatchGAN train step of the port against the JAX package's in
fp64 on the CPU with the plain generator and discriminator
(``InpaintSANetOrg``, ``InpaintSADiscriminatorOrg``: the config's ``org:
true``), as ``tests/test_torch_gan_step.py`` holds the projected ones: every
metric, every G and D gradient, G's BatchNorm statistics and D's ``u`` and
``sigma`` after the step within 1e-9."""

from test_torch_gan_step import check_gan_step
from test_torch_ops import share_cores  # noqa: F401  (autouse)


def test_gan_step_org_matches_jax_fp64():
    check_gan_step("gated_org")
