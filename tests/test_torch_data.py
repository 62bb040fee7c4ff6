"""The port's data layer against ``ocflow_tpu.data`` and OpenCV, on the CPU.

- ``SyntheticFlowWarp`` / ``SyntheticFlow`` (torch blur and remap) against
  the JAX package's (``cv2.GaussianBlur`` / ``cv2.remap``) from the same
  seed and index: images within 1e-4 abs, flow within 1e-4 px (the blur's
  summation order; measured <= 1e-5 and <= 3e-6);
- the blur alone against ``cv2.GaussianBlur`` within 1e-6 abs on uniform
  noise in [-1, 1] (fp32 sums over up to 513 taps; measured <= 1.8e-7),
  and the remap against ``cv2.remap`` within 1e-5 abs;
- ``random_split``, the ``DataLoader``'s batches and the
  ``DeviceCacheLoader``'s batches equal the JAX package's exactly;
- ``load_config`` equals ``yaml.safe_load`` on every file under
  ``configs/`` and refuses what is not flat.
"""

from pathlib import Path

import cv2
import ml_dtypes
import numpy as np
import pytest
import torch
import yaml

from ocflow_torch import data as tdata
from ocflow_torch.train import config as tconfig
from ocflow_torch.train.loop import make_loaders
from ocflow_tpu.data import datasets as jdatasets
from ocflow_tpu.data import pipeline as jpipeline
from test_torch_ops import share_cores  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
IMAGE_TOL, FLOW_TOL = 1e-4, 1e-4


def _max_err(port: dict, ref: dict) -> dict:
    assert set(port) == set(ref)
    for k in ref:
        assert tuple(port[k].shape) == ref[k].shape and port[k].dtype == torch.float32
    return {k: float(np.abs(port[k].numpy() - ref[k]).max()) for k in ref}


@pytest.mark.parametrize("seed,index,size", [
    (0, 0, (64, 128)), (3, 5, (64, 128)), (42, 17, (64, 128)),
    (1, 2, (32, 64)), (7, 30, (32, 64)), (0, 1, (448, 1024))])
def test_synthetic_flow_warp_matches_jax(seed, index, size):
    ref = jdatasets.SyntheticFlowWarp(size=32, image_size=size, seed=seed)[index]
    port = tdata.SyntheticFlowWarp(size=32, image_size=size, seed=seed, device="cpu")[index]
    err = _max_err(port, ref)
    assert err["images"] <= IMAGE_TOL and err["flow"] <= FLOW_TOL, err


@pytest.mark.parametrize("seed,index,size", [(0, 3, (64, 128)), (5, 1, (32, 64))])
def test_synthetic_flow_matches_jax(seed, index, size):
    ref = jdatasets.SyntheticFlow(size=8, image_size=size, seed=seed)[index]
    port = tdata.SyntheticFlow(size=8, image_size=size, seed=seed, device="cpu")[index]
    err = _max_err(port, ref)
    assert err["images"] <= IMAGE_TOL and err["flow"] == 0 and err["occ"] == 0, err


@pytest.mark.parametrize("shape", [(64, 128, 3), (448, 1024), (5, 7, 3), (1, 9)])
@pytest.mark.parametrize("sigma", [2.0, 18.0, 64.0])
def test_gaussian_blur_matches_cv2(shape, sigma):
    """Including pads far beyond the image (sigma 64 pads 256 px), where the
    reflect-101 border folds several times."""
    a = np.random.default_rng(int(sigma)).uniform(-1, 1, shape).astype(np.float32)
    got = tdata.gaussian_blur(torch.from_numpy(a), sigma).numpy()
    assert got.shape == a.shape
    np.testing.assert_allclose(got, cv2.GaussianBlur(a, (0, 0), sigma), rtol=0, atol=1e-6)


def test_remap_matches_cv2():
    """Bilinear at coordinates inside, on and far outside the image, border
    replicate."""
    rng = np.random.default_rng(0)
    img = rng.uniform(-1, 1, (24, 40, 3)).astype(np.float32)
    mx = rng.uniform(-10, 50, (16, 30)).astype(np.float32)
    my = rng.uniform(-10, 34, (16, 30)).astype(np.float32)
    mx[0, :4], my[0, :4] = [0, 39, 39.5, -0.5], [0, 23, 23.25, -3]
    ref = cv2.remap(img, mx, my, cv2.INTER_LINEAR, borderMode=cv2.BORDER_REPLICATE)
    got = tdata.remap_bilinear(torch.from_numpy(img), torch.from_numpy(mx),
                               torch.from_numpy(my)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


class NumpyPairs(jdatasets.Dataset):
    """A dataset of numpy samples fed to both packages' loaders: float
    images and flow, and an integer mask (kept as it is by the caches)."""

    def __init__(self, size=13):
        self.size = size

    def __getitem__(self, index):
        rng = np.random.default_rng((9, index))
        return {"images": rng.normal(size=(4, 6, 6)).astype(np.float32) * 30,
                "flow": rng.normal(size=(4, 6, 2)).astype(np.float32) * 30,
                "mask": rng.integers(0, 3, (4, 6, 1)).astype(np.uint8)}


def test_random_split_matches_jax():
    ds = NumpyPairs(size=44)
    for port, ref in zip(tdata.random_split(ds, (0.8, 0.1, 0.1), seed=42),
                         jpipeline.random_split(ds, (0.8, 0.1, 0.1), seed=42), strict=True):
        assert port.indices == ref.indices
    assert [len(s) for s in tdata.random_split(ds)] == [35, 4, 5]


@pytest.mark.parametrize("shuffle,workers", [(True, 0), (True, 3), (False, 2)])
def test_dataloader_matches_jax(shuffle, workers):
    """Two epochs of batches, order and contents exactly; train drops the
    ragged batch, eval keeps it."""
    ds = NumpyPairs()
    kw = dict(batch_size=4, shuffle=shuffle, seed=7, num_workers=workers, drop_last=shuffle)
    port, ref = tdata.DataLoader(ds, **kw), jpipeline.DataLoader(ds, **kw)
    assert len(port) == len(ref) == (3 if shuffle else 4)
    for epoch in range(2):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        batches = list(zip(port, ref, strict=True))
        assert len(batches) == len(ref)
        for pb, rb in batches:
            assert set(pb) == set(rb)
            for k in rb:
                assert pb[k].numpy().dtype == rb[k].dtype
                np.testing.assert_array_equal(pb[k].numpy(), rb[k])


@pytest.mark.parametrize("shuffle", [True, False])
def test_device_cache_loader_matches_jax(shuffle):
    """Bit for bit: images cached in bf16 and served as fp32, flow fp32,
    the integer mask as it is."""
    ds = NumpyPairs()
    kw = dict(batch_size=4, shuffle=shuffle, seed=3, num_workers=2, drop_last=shuffle)
    port = tdata.DeviceCacheLoader(ds, device="cpu", **kw)
    ref = jpipeline.DeviceCacheLoader(ds, **kw)
    assert {k: v.numel() * v.element_size() for k, v in port.cache().items()} == {
        "images": 13 * 4 * 6 * 6 * 2, "flow": 13 * 4 * 6 * 2 * 4, "mask": 13 * 4 * 6}
    for epoch in range(2):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for pb, rb in zip(port, ref, strict=True):
            for k in rb:
                want = np.asarray(rb[k])
                assert pb[k].numpy().dtype == want.dtype
                np.testing.assert_array_equal(pb[k].numpy(), want)
    images = port.cache()["images"]
    assert images.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        images.float().numpy(),
        np.stack([ds[i]["images"] for i in range(13)]).astype(ml_dtypes.bfloat16)
        .astype(np.float32))


def test_make_loaders_splits_and_batches():
    """44 samples: 35 / 4 / 5, train batches of 8 with the ragged one
    dropped, val and test keep theirs; the device cache holds bf16 images
    and fp32 flow."""
    cfg = tconfig.config_from_dict({
        "dataset_name": "SyntheticFlowWarp", "dataset_size": 44, "image_size": [32, 64],
        "batch_size": 8, "num_workers": 0, "device_cache": True})
    train, val, test = make_loaders(cfg, "cpu")
    assert [len(ld.dataset) for ld in (train, val, test)] == [35, 4, 5]
    assert [len(ld) for ld in (train, val, test)] == [4, 1, 1]
    assert [b["images"].shape[0] for b in val] == [4]
    assert train.cache()["images"].dtype == torch.bfloat16
    assert train.cache()["flow"].dtype == torch.float32
    batch = next(iter(train))
    assert batch["images"].shape == (8, 32, 64, 6) and batch["images"].dtype == torch.float32


def test_build_dataset_refuses_unported_names():
    for name in ("SyntheticInpainting", "MpiSintelCleanInpainting", "FlyingChairsInpainting"):
        with pytest.raises(ValueError, match="A10"):
            tdata.build_dataset(name, root="")


CONFIGS = sorted((REPO / "configs").glob("*.yaml"))


@pytest.mark.parametrize("path", CONFIGS, ids=[p.name for p in CONFIGS])
def test_load_config_equals_yaml(path):
    text = path.read_text()
    raw = tconfig.parse_flat_yaml(text, str(path))
    ref = yaml.safe_load(text)
    assert raw == ref
    assert [type(v) for v in raw.values()] == [type(v) for v in ref.values()]
    assert tconfig.load_config(str(path)) == tconfig.config_from_dict(ref)


@pytest.mark.parametrize("text", [
    "model: pwc\noptim:\n  lr: 1.0e-4\n",       # nested mapping
    "steps:\n  - 1\n  - 2\n",                    # block list
    "a: {b: 1}\n",                               # flow mapping
    "a: [1, [2, 3]]\n",                          # nested list
    "a: &anchor 1\n",                            # anchor
    "a: 1\na: 2\n",                              # repeated key
    "a: 1e-4\n",                                 # a string to YAML 1.1, not a float
    "a: 0x10\n",                                 # another number syntax
])
def test_load_config_refuses_what_is_not_flat(text):
    with pytest.raises(ValueError):
        tconfig.parse_flat_yaml(text)
