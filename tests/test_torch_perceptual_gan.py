"""The SN-PatchGAN step of the port with ``loss_type: vgg`` (the
perceptual loss of the reconstruction on the VGG16 as the generator's
content term) against the JAX package's: fp64 in both, the projected gated
generator and its discriminator at 2x64x128 with the weights and batch of
``tests/test_torch_gan_step.py``, the VGG16 of ``tests/test_torch_perceptual.py``
(the JAX package's seeded one through its ``.npz``), SGD. The metrics
within 1e-5 relative, the generator's gradients within 1e-4 of their
max|grad| (those zero but for rounding within 1e-12 of the net's max)."""

from ocflow_torch.losses.perceptual import init_vgg16
from test_torch_gan_step import gen_flax, hold_tensors, leaves, run_gan_steps
from test_torch_ops import share_cores  # noqa: F401  (autouse)
from test_torch_perceptual import _jax_vgg

LOSS_REL, GRAD_REL = 1e-5, 1e-4


def test_gan_step_with_the_vgg_loss_matches_jax(tmp_path):
    net, variables, path = _jax_vgg(tmp_path)
    (gs, _), metrics, (jgen, _), jmetrics = run_gan_steps(
        "gated", vgg=(net.apply, variables, init_vgg16(weights_path=path)))
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        assert abs(metrics[k] - v) <= LOSS_REL * abs(v), (k, metrics[k], v)
    hold_tensors("G", leaves(gen_flax(gs.model, grads=True)["params"]),
                 leaves(jgen.opt_state), GRAD_REL)
