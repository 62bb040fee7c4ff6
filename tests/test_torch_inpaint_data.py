"""The port's inpainting datasets against ``ocflow_tpu.data``'s, on the CPU.

``SyntheticInpainting`` (texture made by torch, OpenCV's blur there): the
frame within 1e-4, the mask bit for bit, ``occluded`` the frame with the
hole zeroed. ``MpiSintelCleanInpainting``, ``MpiSintelFinalInpainting``
(which reads the clean pass, as the JAX class does) and
``FlyingChairsInpainting`` on small trees in their layouts, with and without
``image_size``: every sample's frames within 1e-6, masks bit for bit.
``make_loaders`` on an inpainting config: the dataset takes the config's
``occlusion_ratio`` and ``static_occ``, and the batches equal the JAX
package's; the device cache carries ``occluded``, ``image`` and ``occ``.
"""

import numpy as np
import pytest
import torch

from ocflow_torch import data as tdata
from ocflow_torch.train import config as tconfig
from ocflow_torch.train.loop import make_loaders
from ocflow_tpu import data as jdata
from ocflow_tpu.train import config as jconfig
from ocflow_tpu.train import loop as jloop
from test_torch_datasets_files import make_trees
from test_torch_ops import share_cores  # noqa: F401  (autouse)

KEYS = {"occluded", "image", "occ"}
SYNTH_TOL, IMAGE_TOL = 1e-4, 1e-6


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    return make_trees(str(tmp_path_factory.mktemp("trees")))


def _check(got, ref, tol):
    assert set(got) == set(ref) == KEYS
    for k in KEYS:
        g = got[k].cpu().numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert g.dtype == ref[k].dtype == np.float32 and g.shape == ref[k].shape, k
        if k == "occ":
            assert np.array_equal(g, ref[k])
        else:
            assert np.abs(g - ref[k]).max() <= tol, k
    assert np.array_equal(np.where(got["occ"] > 0, 0.0, got["image"]), got["occluded"])


@pytest.mark.parametrize("static_occ", [False, True])
@pytest.mark.parametrize("index", [0, 5])
def test_synthetic_inpainting_matches_jax(index, static_occ):
    kw = dict(size=6, image_size=(64, 128), occlusion_ratio=0.4, static_occ=static_occ,
              seed=3)
    ref = jdata.SyntheticInpainting(**kw)[index]
    got = tdata.SyntheticInpainting(**kw, device="cpu")[index]
    assert all(t.device.type == "cpu" for t in got.values())
    _check(got, ref, SYNTH_TOL)


NAMES = {"MpiSintelCleanInpainting": "MpiSintelClean",
         "MpiSintelFinalInpainting": "MpiSintelClean",
         "FlyingChairsInpainting": "FlyingChairs2"}


@pytest.mark.parametrize("image_size", [None, (48, 101)])
@pytest.mark.parametrize("name", sorted(NAMES))
def test_file_inpainting_dataset_matches_jax(trees, name, image_size):
    kw = {"root": trees[NAMES[name]], "occlusion_ratio": 0.3, "seed": 1}
    if image_size:
        kw["image_size"] = image_size
    ref_ds, got_ds = jdata.build_dataset(name, **kw), tdata.build_dataset(name, **kw)
    assert len(got_ds) == len(ref_ds) > 0
    assert got_ds.image_list == ref_ds.image_list
    for i in range(len(ref_ds)):
        _check(got_ds[i], ref_ds[i], IMAGE_TOL)


def test_final_inpainting_reads_the_clean_pass(trees):
    """The reference's quirk, kept: the Final dataset lists ``clean``."""
    root = trees["MpiSintelClean"]
    ds = tdata.build_dataset("MpiSintelFinalInpainting", root=root)
    assert ds.image_list and all("/clean/" in p for p in ds.image_list)


def _inpainting_cfg(**over):
    return {"dataset_name": "SyntheticInpainting", "dataset_size": 20,
            "image_size": [64, 128], "occlusion_ratio": 0.25, "static_occ": True,
            "batch_size": 4, "num_workers": 0, "seed": 2, **over}


def test_make_loaders_on_synthetic_inpainting_matches_jax():
    """The same splits and batches as the JAX package's (its numpy frames
    against the port's CPU tensors), the config's ``occlusion_ratio`` and
    ``static_occ`` reaching the dataset (a 16x32 rectangle at 0.25); the
    device cache keeps the three keys, ``occ`` and the frames in bf16."""
    common = _inpainting_cfg()
    ref_loaders = jloop.make_loaders(jconfig.config_from_dict(common))
    got_loaders = make_loaders(tconfig.config_from_dict(common), "cpu")
    cached = make_loaders(tconfig.config_from_dict({**common, "device_cache": True}), "cpu")
    base = got_loaders[0].dataset.dataset
    assert (base.occlusion_ratio, base.static_occ) == (0.25, True)
    for ref_ld, got_ld, cache_ld in zip(ref_loaders, got_loaders, cached):
        assert got_ld.dataset.indices == list(ref_ld.dataset.indices)
        for r, g, c in zip(list(ref_ld), list(got_ld), list(cache_ld)):
            assert set(r) == set(g) == set(c) == KEYS
            assert torch.all(g["occ"].sum((1, 2, 3)) == 16 * 32)
            for k in KEYS:
                assert np.abs(g[k].numpy() - r[k]).max() <= (0.0 if k == "occ" else SYNTH_TOL)
                assert torch.equal(c[k], g[k].to(torch.bfloat16).float())
    assert {k: v.dtype for k, v in cached[0].cache().items()} == {
        k: torch.bfloat16 for k in KEYS}


def test_make_loaders_on_flying_chairs_inpainting_takes_the_ratio(trees):
    """A file-backed inpainting dataset through ``make_loaders`` with its
    ``root``: free-form masks up to the config's ratio, as the JAX
    package's."""
    common = _inpainting_cfg(dataset_name="FlyingChairsInpainting", static_occ=False,
                             occlusion_ratio=0.35, root=trees["FlyingChairs2"])
    ref = list(jloop.make_loaders(jconfig.config_from_dict(common))[0])
    got = list(make_loaders(tconfig.config_from_dict(common), "cpu")[0])
    assert len(got) == len(ref) > 0
    for r, g in zip(ref, got):
        assert np.array_equal(g["occ"].numpy(), r["occ"])
        assert np.abs(g["image"].numpy() - r["image"]).max() <= IMAGE_TOL
