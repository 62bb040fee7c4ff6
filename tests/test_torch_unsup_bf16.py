"""One occlusion-aware unsupervised train step of the port on FlowNetS
under ``compute_dtype: bfloat16`` == the JAX package's step, on the CPU:
both run the net in fp32 and cast only the loss tail's images to bf16
(``configs/longrun_synthetic.yaml`` trains so). The set-up is
``tests/test_torch_unsup_steps.py``'s.

Bounds, from readings at seeds 0-2 (the test runs seed 0): the metrics
within 3e-4 relative (measured 9.9e-5-2.0e-4, the smoothness terms: their
edge weights read bf16 images), each gradient within 3e-2 of its max|grad|
(measured 1.6e-2-2.8e-2) and the median over the net's tensors within
1e-2 (5.3e-3-9.0e-3): bf16 rounding of the images (eps 7.8e-3) in two
implementations of the warp and the losses. The running statistics after
the step come from the fp32 net, within 1e-5 of max|statistic|.
"""

import jax
import numpy as np

from test_torch_ops import share_cores  # noqa: F401  (autouse)
from test_torch_unsup_steps import _flax, grad_errors, run_steps

BF16_METRIC_REL, BF16_GRAD_REL, BF16_GRAD_MEDIAN = 3e-4, 3e-2, 1e-2


def test_unsupervised_step_with_bf16_loss_tail_matches_jax():
    run = run_steps("flownets", hp={"compute_dtype": "bfloat16"})
    metrics, jmetrics = run["metrics"], run["jmetrics"]
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        assert abs(metrics[k].item() - float(v)) <= BF16_METRIC_REL * abs(float(v)), k
    pj = {k: e[0] for k, e in grad_errors("flownets", run).items()}
    worst = max(pj, key=pj.get)
    assert pj[worst] <= BF16_GRAD_REL, (worst, pj[worst])
    assert np.median(list(pj.values())) <= BF16_GRAD_MEDIAN
    have = dict(jax.tree_util.tree_leaves_with_path(_flax("flownets", run["model"])["batch_stats"]))
    for path, w in jax.tree_util.tree_leaves_with_path(run["jstate"].batch_stats):
        w = np.asarray(w)
        assert np.abs(have[path] - w).max() <= 1e-5 * np.abs(w).max(), path
