"""Hand-written Hopper kernels (``csrc/``) with their Python wrappers and
plain PyTorch versions: ``cost_volume``, ``conv_chain`` (bf16/fp32),
``conv_chain_q8`` (W8A8) and the ``gemm`` probe."""
