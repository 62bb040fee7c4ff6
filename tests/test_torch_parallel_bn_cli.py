"""The trainer CLIs on BatchNorm nets over 2 gloo ranks on the CPU
(``tests/torch_parallel_ranks.py:bn_cli_rank``; the group joined before
``main``, as ``torchrun`` would have it join from its environment), each
against the same CLI in one process on the same config:

- ``python -m ocflow_torch.train_unsupervised`` on
  ``configs/inpainting_gan_fullres.yaml`` (the gated generator with remat,
  the projected discriminator), on ``configs/two_stage_gc_fullres.yaml``
  (``with_gt_flow: true``, the gated inpainter) and on
  ``configs/unsupervised.yaml`` (``network_type: twostage``, ``with_gt_flow:
  false``: the seeded SimpleFlowNet frozen, SimpleOcclusionNet trained);
- ``python -m ocflow_torch.train`` on ``configs/supervised.yaml``
  (SimpleFlowNet).

Each cut to 64x128, a handful of samples and one epoch, batch 2 (the
supervised one 4), every step logged, learning rate 1e-6 (as
``tests/test_torch_parallel_fit.py`` runs: Adam moves a weight whose
gradient is rounding noise by about the learning rate whatever the noise,
so the runs' weights part by that much), outputs in a temporary directory.
Held: exit 0 on every rank and the same test metrics on each (``fit``
checks at its end that the replicas, every model of the state, are equal
bit for bit, and raises if not); rank 0 alone writes the CSV (its rows
those of the single-process run, one header, no step twice), the
TensorBoard events and the checkpoints, and the GAN run's exported
generator; the test metrics within 1e-5 relative of the single-process
run's.
"""

from concurrent.futures import ThreadPoolExecutor

import pytest

import torch_parallel_ranks as ranks
from ocflow_torch.tools.dryrun_multigpu import spawn
from test_torch_cli import _read_csv
from test_torch_ops import share_cores  # noqa: F401  (autouse)
from test_torch_twostage_cli import _config

WORLD = 2
TEST_REL = 1e-5
LR = {"learning_rate": 1e-6}
RUNS = {"gan": ("unsupervised", "configs/inpainting_gan_fullres.yaml",
                {"dataset_size": 10, **LR}),
        "gc": ("unsupervised", "configs/two_stage_gc_fullres.yaml",
               {"dataset_size": 12, **LR}),
        "twostage": ("unsupervised", "configs/unsupervised.yaml",
                     {"with_gt_flow": False, "dataset_size": 12, **LR}),
        "supervised": ("supervised", "configs/supervised.yaml",
                       {"dataset_size": 20, "batch_size": 4, "patience": 1000, **LR})}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' runs; here, meanwhile, the single-process runs."""
    tmp = tmp_path_factory.mktemp("bn_cli")
    multi = {name: (cli, _config(tmp, src, name, **over))
             for name, (cli, src, over) in RUNS.items()}
    with ThreadPoolExecutor(1) as pool:
        done = pool.submit(spawn, ranks.bn_cli_rank, WORLD, str(tmp), multi, timeout=300)
        single = {name: ranks.run_cli(cli, _config(tmp, src, f"{name}_single", **over))
                  for name, (cli, src, over) in RUNS.items()}
        done.result()
    per_rank = [res["results"] for res in ranks.load_ranks(tmp, WORLD)]
    return tmp, per_rank, single


@pytest.mark.parametrize("name", list(RUNS))
def test_cli_over_two_ranks_equals_one_process(runs, name):
    tmp, per_rank, single = runs
    first = per_rank[0][name]
    assert first and all(r[name] == first for r in per_rank[1:])
    assert set(first) == set(single[name])
    for k, v in single[name].items():
        assert abs(first[k] - v) <= TEST_REL * abs(v), (name, k, first[k], v)
    rows, one = _read_csv(tmp / name / "metrics.csv"), _read_csv(tmp / f"{name}_single"
                                                                  / "metrics.csv")
    assert [(r["phase"], r["step"]) for r in rows] == [(r["phase"], r["step"]) for r in one]
    assert len(list((tmp / name / "tb").glob("events.*"))) == 1
    ckpt = list((tmp / name / "ckpt").iterdir())
    assert ckpt
    if name == "gan":
        assert "generator" in {p.name for p in ckpt}


def test_device_cache_of_an_empty_split_yields_no_batch():
    """A split with no sample (the val split of 8 samples, the cut of
    ``chip_smoke.py``'s torchrun GAN CLI) caches nothing and yields no
    batch, so that ``fit`` skips its validation as it does without the
    cache."""
    from ocflow_torch import data

    dataset = data.build_dataset("SyntheticInpainting", size=8, image_size=(64, 128),
                                 device="cpu")
    _, val, _ = data.random_split(dataset, (0.8, 0.1, 0.1), seed=42)
    assert len(val) == 0
    loader = data.DeviceCacheLoader(val, batch_size=2, shuffle=False, num_workers=0,
                                    drop_last=False, device="cpu", block=(0, 2))
    assert len(loader) == 0 and list(loader) == []
