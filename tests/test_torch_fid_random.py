"""``python -m ocflow_torch.evaluate --task inpainting --with_fid
--allow_random_fid`` on the CPU: the seeded InceptionV3 (no weights file
exists in the repository), a finite FID beside PSNR and SSIM, and the
warning that its absolute value means nothing on stderr, as the JAX CLI
prints it."""

import numpy as np

from ocflow_torch import evaluate as tevaluate
from test_torch_fid_cli import DATA
from test_torch_ops import share_cores  # noqa: F401  (autouse)


def test_evaluate_with_random_fid_runs_and_warns(capsys):
    results = tevaluate.main(["--device", "cpu", "--with_fid", "--allow_random_fid"] + DATA)
    assert set(results) == {"psnr", "ssim", "fid"} and np.isfinite(results["fid"])
    assert "RANDOM inception features" in capsys.readouterr().err
