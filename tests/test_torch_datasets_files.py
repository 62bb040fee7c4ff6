"""The port's file-backed flow datasets against ``ocflow_tpu.data``'s, on
the CPU, on trees written here in each dataset's layout: mini-Sintel
(``tests/test_data.py:make_mini_sintel``, clean and final passes), KITTI
2015 (``flow_occ`` and ``flow_noc``, 16-bit flow PNGs), FlyingChairs
(``.ppm``), FlyingChairs2 and the two folder layouts.

Each of the twelve datasets, every sample, with and without
``image_size`` (a non-integer ratio and an odd width): images within
1e-6, flows within 1e-5 (the same arithmetic; OpenCV's resize in the JAX
package), occlusion and validity masks exact; the same keys, shapes and
dtypes. ``make_loaders`` on a FlyingChairs2 config: the same splits and
the same batches as the JAX package's.
"""

import os

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from ocflow_torch import data as tdata
from ocflow_torch.train import config as tconfig
from ocflow_torch.train.loop import make_loaders
from ocflow_tpu import data as jdata
from ocflow_tpu.data.flow_io import write_flo, write_kitti_png_flow
from ocflow_tpu.train import config as jconfig
from ocflow_tpu.train import loop as jloop
from test_data import make_mini_sintel
from test_torch_ops import share_cores  # noqa: F401  (autouse)

IMAGE_TOL, FLOW_TOL = 1e-6, 1e-5
EXACT = ("occ", "valid")


def _img(rng, h, w):
    return rng.integers(0, 255, (h, w, 3), np.uint8)


def _flow(rng, h, w, scale=5.0):
    return (rng.standard_normal((h, w, 2)) * scale).astype(np.float32)


def _occ(rng, h, w):
    return (rng.uniform(size=(h, w)) > 0.6).astype(np.uint8) * 255


def make_trees(root):
    """Every layout under ``root``; returns ``{dataset: root}``."""
    rng = np.random.default_rng(0)
    sintel = os.path.join(root, "sintel")
    make_mini_sintel(sintel)
    for s in range(2):
        os.makedirs(os.path.join(sintel, "final", f"scene_{s}"))
        for f in range(1, 4):
            imageio.imwrite(os.path.join(sintel, "final", f"scene_{s}", f"frame_{f:04d}.png"),
                            _img(rng, 100, 150))
    kitti = os.path.join(root, "kitti")
    for sub in ("image_2", "flow_occ", "flow_noc"):
        os.makedirs(os.path.join(kitti, sub))
    for i in range(3):
        for suffix in ("10", "11"):
            imageio.imwrite(os.path.join(kitti, "image_2", f"{i:06d}_{suffix}.png"),
                            _img(rng, 72, 136))
        for sub in ("flow_occ", "flow_noc"):
            path = os.path.join(kitti, sub, f"{i:06d}_10.png")
            write_kitti_png_flow(path, rng.uniform(-30, 30, (72, 136, 2)).astype(np.float32))
            # sparse ground truth: some pixels invalid (blue channel 0)
            raw = cv2.imread(path, cv2.IMREAD_UNCHANGED)  # BGR
            raw[..., 0] = rng.uniform(size=(72, 136)) > 0.3
            cv2.imwrite(path, raw)
    chairs = os.path.join(root, "chairs")
    os.makedirs(chairs)
    for i in range(3):
        for k in (1, 2):
            img = _img(rng, 70, 90)
            with open(os.path.join(chairs, f"{i:05d}_img{k}.ppm"), "wb") as f:
                f.write(b"P6\n90 70\n255\n" + img.tobytes())
        write_flo(os.path.join(chairs, f"{i:05d}_flow.flo"), _flow(rng, 70, 90))
    chairs2 = os.path.join(root, "chairs2")
    os.makedirs(chairs2)
    for i in range(10):
        for k in (1, 2):
            imageio.imwrite(os.path.join(chairs2, f"{i:05d}-img_{k}.png"), _img(rng, 64, 128))
        write_flo(os.path.join(chairs2, f"{i:05d}-flow_01.flo"), _flow(rng, 64, 128))
        imageio.imwrite(os.path.join(chairs2, f"{i:05d}-occ_01.png"), _occ(rng, 64, 128))
    folder = os.path.join(root, "folder")
    for sub in ("img_1", "img_2", "flow", "occlusion"):
        os.makedirs(os.path.join(folder, sub))
    for i in range(3):
        for sub in ("img_1", "img_2"):
            imageio.imwrite(os.path.join(folder, sub, f"{i:04d}.png"), _img(rng, 66, 130))
        write_flo(os.path.join(folder, "flow", f"{i:04d}.flo"), _flow(rng, 66, 130))
        imageio.imwrite(os.path.join(folder, "occlusion", f"{i:04d}.png"),
                        _occ(rng, 66, 130))
    return {**{k: sintel for k in ("MpiSintelClean", "MpiSintelFinal", "MpiSintelOccClean",
                                   "MpiSintelOccFinal", "MpiSintelFlowOccClean",
                                   "MpiSintelFlowOccFinal")},
            "KITTI2015": kitti, "KITTI2015Noc": kitti, "FlyingChairs": chairs,
            "FlyingChairs2": chairs2, "ImagesFromFolder": os.path.join(sintel, "clean",
                                                                       "scene_0"),
            "ImgFlowOccFromFolder": folder}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    return make_trees(str(tmp_path_factory.mktemp("trees")))


def test_every_file_dataset_is_registered():
    assert len(tdata.FILE_DATASETS) == 12
    assert set(tdata.FILE_DATASETS) <= set(jdata.DATASET_REGISTRY)
    assert set(jdata.DATASET_REGISTRY) - set(tdata.DATASET_REGISTRY) == {
        "SyntheticInpainting", "MpiSintelCleanInpainting", "MpiSintelFinalInpainting",
        "FlyingChairsInpainting"}


@pytest.mark.parametrize("image_size", [None, (48, 101)])
@pytest.mark.parametrize("name", sorted(tdata.FILE_DATASETS))
def test_dataset_matches_jax(trees, name, image_size):
    kw = {"root": trees[name]}
    if image_size:
        kw["image_size"] = image_size
    ref_ds, port_ds = jdata.build_dataset(name, **kw), tdata.build_dataset(name, **kw)
    assert len(port_ds) == len(ref_ds) > 0
    for i in range(len(ref_ds)):
        ref, got = ref_ds[i], port_ds[i]
        assert set(got) == set(ref)
        for k, r in ref.items():
            g = got[k]
            assert isinstance(g, np.ndarray) and g.dtype == r.dtype == np.float32, k
            assert g.shape == r.shape, (k, g.shape, r.shape)
            err = np.abs(g - r).max()
            tol = 0.0 if k in EXACT else IMAGE_TOL if k == "images" else FLOW_TOL
            assert err <= tol, (name, i, k, err)
    if image_size:
        assert got["images"].shape[:2] == image_size


def test_make_loaders_on_flying_chairs2_matches_jax(trees):
    """The same split indices and batches (train over two epochs, val,
    test), from a config naming the dataset and its ``root``; the device
    cache holds the file data like the procedural data."""
    common = {"dataset_name": "FlyingChairs2", "root": trees["FlyingChairs2"],
              "batch_size": 2, "num_workers": 2, "seed": 3}
    ref_loaders = jloop.make_loaders(jconfig.config_from_dict(common))
    got_loaders = make_loaders(tconfig.config_from_dict(common), "cpu")
    cached = make_loaders(tconfig.config_from_dict({**common, "device_cache": True}), "cpu")
    for ref_ld, got_ld, cache_ld in zip(ref_loaders, got_loaders, cached):
        assert got_ld.dataset.indices == list(ref_ld.dataset.indices)
        for epoch in (0, 1):
            for ld in (ref_ld, got_ld, cache_ld):
                ld.set_epoch(epoch)
            ref_b, got_b, cache_b = list(ref_ld), list(got_ld), list(cache_ld)
            assert len(got_b) == len(ref_b) == len(cache_b) > 0
            for r, g, c in zip(ref_b, got_b, cache_b):
                assert set(g) == set(r) == set(c) == {"images", "flow", "occ"}
                for k in r:
                    assert g[k].dtype == torch.float32
                    assert np.abs(g[k].numpy() - r[k]).max() <= (
                        IMAGE_TOL if k == "images" else 0.0)
                    # the cache keeps images and the 0/1 occ in bf16, flow in fp32
                    assert torch.equal(c[k], g[k].to(torch.bfloat16).float()
                                       if k != "flow" else g[k])


def test_helpers_match_jax():
    """The datasets' helpers on the same arrays and the same generator
    state: the crop offsets drawn, the crops, the range map, the floor-64
    rule, the normalization and the binarization, exactly."""
    from ocflow_torch.data import datasets as tds
    from ocflow_tpu.data import datasets as jds

    img = np.random.default_rng(9).integers(0, 256, (70, 133, 3), np.uint8)
    for seed in range(3):
        got = tds.StaticRandomCrop(np.random.default_rng(seed), (70, 133), (64, 96))
        ref = jds.StaticRandomCrop(np.random.default_rng(seed), (70, 133), (64, 96))
        assert (got.h1, got.w1) == (ref.h1, ref.w1)
        assert np.array_equal(got(img), ref(img))
    assert np.array_equal(tds.rescale(img.astype(np.float32), (-1.0, 1.0)),
                          jds.rescale(img.astype(np.float32), (-1.0, 1.0)))
    for size in ((436, 1024), (375, 1242), (384, 512), (64, 128)):
        assert tds.floor64(size) == jds.floor64(size)
    assert np.array_equal(tds.center_crop(img, 64, 128), jds.center_crop(img, 64, 128))
    assert np.array_equal(tds.normalize_image(img), jds.normalize_image(img))
    occ = np.random.default_rng(10).uniform(size=(5, 7, 1)).astype(np.float32)
    assert np.array_equal(tds.binarize_occ(occ), jds.binarize_occ(occ))
