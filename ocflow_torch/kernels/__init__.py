"""Hand-written Hopper kernels (``csrc/``) with their Python wrappers and
plain PyTorch versions: ``cost_volume`` and ``conv_chain``."""
