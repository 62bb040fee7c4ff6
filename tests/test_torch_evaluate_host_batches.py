"""``evaluate --task inpainting`` keeps its batches, and FID's image stacks,
on the host (ROADMAP §C6), as the JAX CLI's ``list(loader)`` and numpy
stacks do; the numbers stay what they were.

On the CPU at 64x128, ``SyntheticInpainting`` (6 samples, batches of 4, the
last one ragged), ``--model simple`` seeded, ``--with_fid
--allow_random_fid``: PSNR, SSIM and FID from the CLI equal, bit for bit,
the values of the metric functions on the batches as the CLI held them
before (every batch placed by ``device_iterator``, FID's real and completed
images stacked where the batches were), and the batches the CLI hands the
metrics lie on the CPU. FID is held through its inputs: the means and
covariances the CLI hands ``frechet_distance``, a deterministic function of
them alone, equal those of the old path bit for bit, and the CLI reports
what it returns (here a sum of its inputs: its ``sqrtm`` of a 2048x2048
product takes ~14 s alone on this CPU and minutes beside other workers;
``tests/test_torch_fid*.py`` hold the distance itself). The card's side,
peak memory flat from 4 batches to 16, is
``tests/test_torch_gpu.py::test_evaluate_inpainting_memory_stays_flat``.
"""

import numpy as np
import torch

from ocflow_torch import data as data_lib
from ocflow_torch import evaluate
from ocflow_torch.metrics import (activation_statistics, calculate_psnr, calculate_ssim,
                                  completed_images, get_activations, init_inception)
from ocflow_torch.metrics import fid as fid_mod
from ocflow_torch.models import load_model
from test_torch_ops import share_cores  # noqa: F401  (autouse)

SIZE, IMAGE, BATCH = 6, (64, 128), 4


def stand_in(mu1, sigma1, mu2, sigma2):
    """A cheap function of every input of ``frechet_distance``."""
    return float(mu1.sum() + 2 * sigma1.sum() + 3 * mu2.sum() + 4 * sigma2.sum())


def test_evaluate_inpainting_keeps_host_batches_and_its_numbers(monkeypatch):
    held, distances = [], []

    def keep(fn, batches, **kw):
        held.append(batches)
        return calculate_psnr(fn, batches, **kw)

    def distance(*stats):
        distances.append(stats)
        return stand_in(*stats)

    monkeypatch.setattr(evaluate, "calculate_psnr", keep)
    monkeypatch.setattr(fid_mod, "frechet_distance", distance)
    got = evaluate.main(["--task", "inpainting", "--model", "simple", "--dataset",
                         "SyntheticInpainting", "--dataset_size", str(SIZE), "--image_size",
                         *map(str, IMAGE), "--batch_size", str(BATCH), "--with_fid",
                         "--allow_random_fid", "--device", "cpu"])
    assert [len(b["image"]) for b in held[0]] == [4, 2]
    assert all(v.device.type == "cpu" for b in held[0] for v in b.values())

    dev = torch.device("cpu")
    ds = data_lib.build_dataset("SyntheticInpainting", size=SIZE, image_size=IMAGE, device=dev)
    batches = list(data_lib.device_iterator(data_lib.DataLoader(ds, BATCH, drop_last=False),
                                            dev))
    inpaint = evaluate.inpaint_fn(load_model("inpainting", "simple", "", dev))
    completes, reals = zip(*completed_images(inpaint, batches))
    extract = evaluate.inception_features(init_inception(device=dev))
    stats = [s for imgs in (reals, completes)
             for s in activation_statistics(get_activations(extract, torch.cat(imgs)))]
    cli_stats, = distances
    assert all(np.array_equal(a, b) for a, b in zip(cli_stats, stats, strict=True))
    want = {"psnr": calculate_psnr(inpaint, batches),
            "ssim": calculate_ssim(inpaint, batches), "fid": stand_in(*stats)}
    assert got == want, (got, want)
