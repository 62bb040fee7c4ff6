"""One occlusion-aware unsupervised train step of the port on FlowNet (the FPN trunk, d=4 at five levels)
== the JAX package's step, on the CPU: the set-up, the bounds and their
readings are ``tests/test_torch_unsup_steps.py``'s (one JAX step on this
net takes 20-25 s to compile and run, hence a file of its own)."""

from test_torch_ops import share_cores  # noqa: F401  (autouse)
from test_torch_unsup_steps import check_step


def test_unsupervised_step_matches_jax():
    check_step("flownet")
