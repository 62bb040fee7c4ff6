"""Datasets (port of ``ocflow_tpu/data/datasets.py``): the procedural
``SyntheticFlow`` and ``SyntheticFlowWarp``, and the twelve file-backed
flow datasets (Sintel, FlyingChairs, FlyingChairs2, KITTI 2015, folders).

A procedural sample is a dict of NHWC tensors on the dataset's device:
``images`` [H, W, 6] (frames 1 | 2 on channels, in [-1, 1]), ``flow`` [H,
W, 2] and, with ``with_occ``, ``occ`` [H, W, 1]. The random draws are the
JAX package's numpy calls in the same order, from
``np.random.default_rng((seed, index % size))``, so a sample equals its
counterpart up to rounding; the Gaussian blur and the bilinear remap (OpenCV
there) are torch code on the device (:func:`gaussian_blur`,
:func:`remap_bilinear`).

A file-backed sample is decoded on the host and returned as numpy arrays
with the JAX package's keys, shapes and dtypes (``images`` [H, W, 6],
``flow`` [H, W, 2], ``occ`` [H, W, 1], KITTI's ``valid`` [H, W, 1], all
float32), the same directory layouts, the centre crop to multiples of 64,
the resize with flow rescale (OpenCV's bilinear, ``data.resize``) and the
occlusion binarization; the loaders put them on the device. The decoding
is ``data.native_io`` (no OpenCV, PIL or imageio).

``SyntheticInpainting`` and the three inpainting datasets are not ported
yet (ROADMAP A10).
"""

from __future__ import annotations

import math
from glob import glob
from os.path import isfile, join
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ocflow_torch import full_fp32_convs, resolve_device
from ocflow_torch.data import native_io
from ocflow_torch.data.flow_io import read_kitti_png_flow, resize_flow_np
from ocflow_torch.data.frame_io import read_gen
from ocflow_torch.data.resize import resize_linear


def _reflect101(n: int, pad: int, device) -> torch.Tensor:
    """Indices ``-pad .. n-1+pad`` folded into ``[0, n)`` by reflect-101
    (``dcb|abcd|cba``), for any ``pad``: the border repeats with period
    ``2(n-1)``. ``F.pad(mode='reflect')`` refuses pads of ``n`` or more."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = i.remainder(period)
    return torch.where(i >= n, period - i, i)


def _gaussian_kernel(sigma: float, device) -> torch.Tensor:
    """OpenCV's Gaussian for a float image with ``ksize=(0, 0)``: size
    ``round(8 sigma + 1) | 1``, weights normalized to sum 1, fp32."""
    k = int(math.floor(sigma * 8 + 1 + 0.5)) | 1
    x = torch.arange(k, dtype=torch.float64) - (k - 1) / 2
    g = torch.exp(-x * x / (2 * sigma * sigma))
    return (g / g.sum()).to(device=device, dtype=torch.float32)


def gaussian_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """``cv2.GaussianBlur(x, (0, 0), sigma)`` of an fp32 ``[H, W]`` or
    ``[H, W, C]`` tensor: separable, reflect-101 borders, fp32 sums (no
    TF32)."""
    kern = _gaussian_kernel(sigma, x.device)
    r = kern.numel() // 2
    h, w = x.shape[:2]
    planes = (x[None] if x.dim() == 2 else x.permute(2, 0, 1)).float()
    with full_fp32_convs(torch.float32):
        # rows: [C*H, 1, W + 2r] -> [C*H, 1, W]
        y = planes.index_select(2, _reflect101(w, r, x.device))
        y = F.conv1d(y.reshape(-1, 1, w + 2 * r), kern.view(1, 1, -1)).view(-1, h, w)
        # columns, on the transposed planes
        y = y.transpose(1, 2).index_select(2, _reflect101(h, r, x.device))
        y = F.conv1d(y.reshape(-1, 1, h + 2 * r), kern.view(1, 1, -1)).view(-1, w, h)
    y = y.transpose(1, 2)
    return y[0].contiguous() if x.dim() == 2 else y.permute(1, 2, 0).contiguous()


def remap_bilinear(img: torch.Tensor, map_x: torch.Tensor,
                   map_y: torch.Tensor) -> torch.Tensor:
    """``cv2.remap(img, map_x, map_y, INTER_LINEAR, BORDER_REPLICATE)`` of
    an fp32 ``[H, W, C]`` image at fp32 ``[H', W']`` coordinates: bilinear
    over the four neighbours, each index clamped into the image."""
    h, w, c = img.shape
    x0f, y0f = torch.floor(map_x), torch.floor(map_y)
    fx, fy = map_x - x0f, map_y - y0f
    x0, y0 = x0f.long(), y0f.long()
    flat = img.reshape(h * w, c)

    def tap(yi, xi):
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        return flat.index_select(0, idx.reshape(-1)).view(*map_x.shape, c)

    fx, fy = fx[..., None], fy[..., None]
    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bottom = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bottom * fy


class Dataset:
    """Minimal map-style dataset protocol."""

    size: int
    replicates: int = 1

    def __len__(self):
        return self.size * self.replicates

    def __getitem__(self, index: int) -> dict:
        raise NotImplementedError


def _uniform(rng: np.random.Generator, shape, device) -> torch.Tensor:
    """``rng.uniform(-1, 1, shape).astype(np.float32)`` on ``device``."""
    return torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)).to(device)


class SyntheticFlow(Dataset):
    """Procedural pairs with known flow: frame 2 is frame 1 translated by a
    random integer shift (``ocflow_tpu`` ``SyntheticFlow``)."""

    def __init__(self, size=64, image_size=(64, 128), max_shift=4, seed=0,
                 with_occ=True, device=None):
        self.size = size
        self.image_size = image_size
        self.max_shift = max_shift
        self.seed = seed
        self.with_occ = with_occ
        self.device = resolve_device(device)

    def __getitem__(self, index):
        rng = np.random.default_rng((self.seed, index % self.size))
        h, w = self.image_size
        sx = int(rng.integers(-self.max_shift, self.max_shift + 1))
        sy = int(rng.integers(-self.max_shift, self.max_shift + 1))
        pad = self.max_shift
        base = _uniform(rng, (h + 2 * pad, w + 2 * pad, 3), self.device)
        base = (gaussian_blur(base, 3.0) * 3.0).clamp(-1.0, 1.0)
        img1 = base[pad:pad + h, pad:pad + w]
        img2 = base[pad + sy:pad + sy + h, pad + sx:pad + sx + w]
        # img2[y, x] = img1[y + sy, x + sx]: the flow is (-sx, -sy)
        flow = torch.empty((h, w, 2), device=self.device)
        flow[..., 0], flow[..., 1] = -sx, -sy
        sample = {"images": torch.cat([img1, img2], -1), "flow": flow}
        if self.with_occ:
            sample["occ"] = torch.zeros((h, w, 1), device=self.device)
        return sample


class SyntheticFlowWarp(Dataset):
    """Procedural pairs with a smooth non-rigid flow (``ocflow_tpu``
    ``SyntheticFlowWarp``): a multi-octave texture for frame 2, a random
    affine motion plus a band-limited random deformation for the flow F,
    and frame 1 inverse-warped through it, img1(p) = img2(p + F(p)) (the
    relation the backward warp assumes), border replicate outside the view.

    Arithmetic follows the JAX package's numpy: the texture and the blurred
    fields in fp32, the flow's affine part in float64 (numpy promotes the
    float64 translation draw), the flow and the sampling map cast to fp32.
    """

    def __init__(self, size=512, image_size=(448, 1024), max_shift=16.0,
                 seed=0, with_occ=False, device=None):
        self.size = size
        self.image_size = image_size
        self.max_shift = float(max_shift)
        self.seed = seed
        self.with_occ = with_occ
        self.device = resolve_device(device)

    def __len__(self):
        return self.size

    def __getitem__(self, index):
        rng = np.random.default_rng((self.seed, index % self.size))
        h, w = self.image_size
        dev = self.device

        # multi-octave texture in [-1, 1]
        img2 = torch.zeros((h, w, 3), device=dev)
        for sigma, amp in ((2.0, 1.0), (6.0, 1.5), (18.0, 2.0)):
            img2 += gaussian_blur(_uniform(rng, (h, w, 3), dev), sigma) * amp * sigma
        img2 = (img2 / img2.abs().max() * 1.6).clamp(-1.0, 1.0)

        # flow = affine (translation + small rotation / zoom) + smooth field
        yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                                torch.arange(w, dtype=torch.float32, device=dev),
                                indexing="ij")
        cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
        tx, ty = rng.uniform(-self.max_shift, self.max_shift, 2)
        rot = rng.uniform(-0.02, 0.02)
        zoom = rng.uniform(-0.02, 0.02)
        u = float(tx) + (zoom * (xx - cx)).double() - (rot * (yy - cy)).double()
        v = float(ty) + (zoom * (yy - cy)).double() + (rot * (xx - cx)).double()
        for sigma, amp in ((24.0, 4.0), (64.0, 8.0)):
            u += (gaussian_blur(_uniform(rng, (h, w), dev), sigma) * amp * sigma / 8.0).double()
            v += (gaussian_blur(_uniform(rng, (h, w), dev), sigma) * amp * sigma / 8.0).double()

        img1 = remap_bilinear(img2, (xx.double() + u).float(), (yy.double() + v).float())
        sample = {"images": torch.cat([img1, img2], -1),
                  "flow": torch.stack([u, v], -1).float()}
        if self.with_occ:
            sample["occ"] = torch.zeros((h, w, 1), device=dev)
        return sample


def normalize_image(img: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] -> float32 [-1, 1]: ``(x / 255 - 0.5) / 0.5``."""
    return (img.astype(np.float32) / 255.0 - 0.5) / 0.5


def center_crop(img: np.ndarray, th: int, tw: int) -> np.ndarray:
    h, w = img.shape[:2]
    return img[(h - th) // 2:(h + th) // 2, (w - tw) // 2:(w + tw) // 2]


class StaticRandomCrop:
    """A crop offset drawn once and applied to every array, so a pair, its
    flow and its occlusion stay aligned."""

    def __init__(self, rng: np.random.Generator, image_size, crop_size):
        self.th, self.tw = crop_size
        h, w = image_size
        self.h1 = int(rng.integers(0, max(h - self.th, 1)))
        self.w1 = int(rng.integers(0, max(w - self.tw, 1)))

    def __call__(self, img: np.ndarray) -> np.ndarray:
        return img[self.h1:self.h1 + self.th, self.w1:self.w1 + self.tw]


def rescale(images: np.ndarray, range_=(0.0, 1.0), old_range=(0.0, 255.0)) -> np.ndarray:
    """Linear map of ``old_range`` onto ``range_``."""
    lo, hi = range_
    olo, ohi = old_range
    return (images - olo) / (ohi - olo) * (hi - lo) + lo


def floor64(size: Sequence[int]) -> tuple[int, int]:
    """The crop of a frame: each side floored to a multiple of 64."""
    h, w = size
    if h % 64 or w % 64:
        return (h // 64) * 64, (w // 64) * 64
    return h, w


def _resize_img(img: np.ndarray, height: int, width: int) -> np.ndarray:
    out = resize_linear(img, height, width)
    return out[..., None] if out.ndim == 2 else out


def binarize_occ(occ: np.ndarray) -> np.ndarray:
    """1 where ``occ > 0.5``, else 0 (float32)."""
    return (occ > 0.5).astype(np.float32)


class _FlowPairDataset(Dataset):
    """A frame pair, with a flow and an occlusion mask where the lists have
    them. Frames, flows and masks are centre-cropped to the first frame's
    size floored to multiples of 64, then resized to ``image_size`` if it
    is given. Without ``image_size`` an 8-bit RGB pair takes the decoder's
    fused decode, crop and ``x / 127.5 - 1`` pass; other frames are decoded,
    cropped and mapped by ``(x / 255 - 0.5) / 0.5``, as in the JAX
    package."""

    def __init__(self, image_list, flow_list=None, occ_list=None, image_size=None,
                 replicates=1):
        self.image_list = image_list
        self.flow_list = flow_list
        self.occ_list = occ_list
        self.image_size = image_size
        self.replicates = replicates
        self.size = len(image_list)
        if self.size == 0:
            raise FileNotFoundError("Empty dataset: no files matched")
        self.render_size = floor64(read_gen(image_list[0][0]).shape[:2])

    def __getitem__(self, index):
        index = index % self.size
        th, tw = self.render_size
        images = None
        if not self.image_size:
            images = native_io.read_pair_norm(*self.image_list[index][:2], th, tw)
        if images is None:
            img1 = center_crop(read_gen(self.image_list[index][0]), th, tw)
            img2 = center_crop(read_gen(self.image_list[index][1]), th, tw)
            if self.image_size:
                img1 = _resize_img(img1, *self.image_size)
                img2 = _resize_img(img2, *self.image_size)
            images = np.concatenate([normalize_image(img1), normalize_image(img2)], axis=-1)
        sample = {"images": images}
        if self.flow_list is not None:
            flow = center_crop(read_gen(self.flow_list[index]).astype(np.float32), th, tw)
            if self.image_size:
                flow = resize_flow_np(flow, *self.image_size)
            sample["flow"] = flow
        if self.occ_list is not None:
            occ = center_crop(read_gen(self.occ_list[index]).astype(np.float32), th, tw)
            if occ.ndim == 2:
                occ = occ[..., None]
            occ = occ[..., :1]
            if occ.max() > 1.5:  # stored as a 0/255 PNG
                occ = occ / 255.0
            if self.image_size:
                occ = _resize_img(occ, *self.image_size)
            sample["occ"] = binarize_occ(occ)
        return sample


def _sintel_frames(root: str, dstype: str, listed_root: str, pattern: str):
    """For each file under ``root/listed_root`` matching ``pattern``
    (``<scene>/frame_NNNN.<ext>``), the Sintel frames N and N + 1 of
    ``root/dstype/<scene>``; returns ``(image pairs, files, prefixes and
    frame numbers)``."""
    listed = join(root, listed_root)
    image_root = join(root, dstype)
    pairs, files, frames = [], [], []
    for file in sorted(glob(join(listed, pattern))):
        fbase = file[len(listed) + 1:]
        fprefix, fnum = fbase[:-8], int(fbase[-8:-4])
        img1 = join(image_root, fprefix + f"{fnum:04d}.png")
        img2 = join(image_root, fprefix + f"{fnum + 1:04d}.png")
        if not (isfile(img1) and isfile(img2)):
            raise FileNotFoundError(f"Cannot find the frames {img1}, {img2}")
        pairs.append([img1, img2])
        files.append(file)
        frames.append((fprefix, fnum))
    return pairs, files, frames


class MpiSintel(_FlowPairDataset):
    """Sintel pairs and their ``.flo`` flow: ``root/flow/<scene>/
    frame_NNNN.flo`` with ``root/<dstype>/<scene>/frame_NNNN.png`` and the
    next frame."""

    def __init__(self, root="", dstype="clean", replicates=1, image_size=None):
        pairs, flows, _ = _sintel_frames(root, dstype, "flow", "*/*.flo")
        super().__init__(pairs, flows, None, image_size, replicates)


class MpiSintelClean(MpiSintel):
    def __init__(self, root="", replicates=1, image_size=None):
        super().__init__(root, "clean", replicates, image_size)


class MpiSintelFinal(MpiSintel):
    def __init__(self, root="", replicates=1, image_size=None):
        super().__init__(root, "final", replicates, image_size)


class MpiSintelOcc(_FlowPairDataset):
    """Sintel pairs and their occlusion masks (``root/occlusions/<scene>/
    frame_NNNN.png``): ``{'images', 'occ'}``."""

    def __init__(self, root="", dstype="clean", replicates=1, image_size=None):
        pairs, occs, _ = _sintel_frames(root, dstype, "occlusions", "*/*.png")
        super().__init__(pairs, None, occs, image_size, replicates)


class MpiSintelOccClean(MpiSintelOcc):
    def __init__(self, root="", replicates=1, image_size=None):
        super().__init__(root, "clean", replicates, image_size)


class MpiSintelOccFinal(MpiSintelOcc):
    def __init__(self, root="", replicates=1, image_size=None):
        super().__init__(root, "final", replicates, image_size)


class MpiSintelFlowOcc(_FlowPairDataset):
    """Sintel pairs with flow and occlusion mask: ``{'images', 'flow',
    'occ'}``."""

    def __init__(self, root="", dstype="clean", replicates=1, image_size=None):
        pairs, flows, frames = _sintel_frames(root, dstype, "flow", "*/*.flo")
        occs = [join(root, "occlusions", f"{p}{n:04d}.png") for p, n in frames]
        missing = [o for o in occs if not isfile(o)]
        if missing:
            raise FileNotFoundError(f"Cannot find the occlusion masks {missing[:3]}")
        super().__init__(pairs, flows, occs, image_size, replicates)


class MpiSintelFlowOccClean(MpiSintelFlowOcc):
    def __init__(self, root="", replicates=1, image_size=None):
        super().__init__(root, "clean", replicates, image_size)


class MpiSintelFlowOccFinal(MpiSintelFlowOcc):
    def __init__(self, root="", replicates=1, image_size=None):
        super().__init__(root, "final", replicates, image_size)


def _consecutive_pairs(images: list, n: int) -> list:
    if len(images) // 2 != n:
        raise FileNotFoundError(f"{len(images)} frames for {n} flows")
    return [[images[2 * i], images[2 * i + 1]] for i in range(n)]


class FlyingChairs(_FlowPairDataset):
    """FlyingChairs: ``*.ppm`` frame pairs in name order with ``*.flo``."""

    def __init__(self, root="", replicates=1, image_size=None):
        flows = sorted(glob(join(root, "*.flo")))
        pairs = _consecutive_pairs(sorted(glob(join(root, "*.ppm"))), len(flows))
        super().__init__(pairs, flows, None, image_size, replicates)


class FlyingChairs2(_FlowPairDataset):
    """FlyingChairs2: ``NNNNN-img_{1,2}.png`` with ``NNNNN-flow_01.flo`` and
    ``NNNNN-occ_01.png``, the default unsupervised training set."""

    def __init__(self, root="", replicates=1, image_size=None):
        flows = sorted(glob(join(root, "*-flow_01.flo")))
        occs = sorted(glob(join(root, "*-occ_01.png")))
        pairs = _consecutive_pairs(sorted(glob(join(root, "*-img_*.png"))), len(flows))
        super().__init__(pairs, flows, occs, image_size, replicates)


class ImagesFromFolder(_FlowPairDataset):
    """Consecutive frames of a folder (``*.<iext>`` in name order) as pairs,
    images only."""

    def __init__(self, root="", iext="png", replicates=1, image_size=None):
        images = sorted(glob(join(root, "*." + iext)))
        pairs = [[images[i], images[i + 1]] for i in range(len(images) - 1)]
        super().__init__(pairs, None, None, image_size, replicates)


class ImgFlowOccFromFolder(_FlowPairDataset):
    """The folder layout ``img_1/``, ``img_2/``, ``flow/``, ``occlusion/``,
    each in name order."""

    def __init__(self, root="", iext="png", replicates=1, image_size=None):
        first = sorted(glob(join(root, "img_1", "*." + iext)))
        second = sorted(glob(join(root, "img_2", "*." + iext)))
        flows = sorted(glob(join(root, "flow", "*.flo")))
        occs = sorted(glob(join(root, "occlusion", "*." + iext)))
        if not len(first) == len(second) == len(flows) == len(occs):
            raise FileNotFoundError(
                f"img_1 / img_2 / flow / occlusion: {len(first)} / {len(second)} / "
                f"{len(flows)} / {len(occs)} files")
        super().__init__([list(p) for p in zip(first, second)], flows, occs, image_size,
                         replicates)


class KITTI2015(_FlowPairDataset):
    """KITTI 2015's training layout: ``root/image_2/NNNNNN_10.png`` and
    ``NNNNNN_11.png`` with the 16-bit flow ``root/<flow_type>/NNNNNN_10.png``
    (``flow_occ``: every valid pixel, ``flow_noc``: the non-occluded ones).

    Returns ``{'images', 'flow' [H, W, 2], 'valid' [H, W, 1]}``; KITTI's
    ground truth is sparse, so invalid pixels carry zero flow and valid 0
    (with ``image_size``, ``valid`` is resized and thresholded at 0.5)."""

    def __init__(self, root="", flow_type="flow_occ", replicates=1, image_size=None):
        image_root = join(root, "image_2")
        flow_root = join(root, flow_type)
        pairs, flows = [], []
        for file in sorted(glob(join(flow_root, "*_10.png"))):
            frame = file[len(flow_root) + 1:-7]
            img1 = join(image_root, f"{frame}_10.png")
            img2 = join(image_root, f"{frame}_11.png")
            if not (isfile(img1) and isfile(img2)):
                raise FileNotFoundError(f"Cannot find the frames {img1}, {img2}")
            pairs.append([img1, img2])
            flows.append(file)
        # the flow is read by the 16-bit reader below, not the base class
        super().__init__(pairs, None, None, image_size, replicates)
        self.kitti_flow_list = flows

    def __getitem__(self, index):
        sample = super().__getitem__(index)
        index = index % self.size
        th, tw = self.render_size
        raw = read_kitti_png_flow(self.kitti_flow_list[index]).astype(np.float32)
        raw = center_crop(raw, th, tw)
        flow, valid = raw[..., :2], raw[..., 2:3]
        if self.image_size:
            flow = resize_flow_np(flow, *self.image_size)
            valid = (_resize_img(valid, *self.image_size) > 0.5).astype(np.float32)
        sample["flow"] = flow * valid
        sample["valid"] = valid
        return sample


class KITTI2015Noc(KITTI2015):
    def __init__(self, root="", replicates=1, image_size=None):
        super().__init__(root, "flow_noc", replicates, image_size)


FILE_DATASETS = {
    "KITTI2015": KITTI2015,
    "KITTI2015Noc": KITTI2015Noc,
    "MpiSintelClean": MpiSintelClean,
    "MpiSintelFinal": MpiSintelFinal,
    "MpiSintelOccClean": MpiSintelOccClean,
    "MpiSintelOccFinal": MpiSintelOccFinal,
    "MpiSintelFlowOccClean": MpiSintelFlowOccClean,
    "MpiSintelFlowOccFinal": MpiSintelFlowOccFinal,
    "FlyingChairs": FlyingChairs,
    "FlyingChairs2": FlyingChairs2,
    "ImagesFromFolder": ImagesFromFolder,
    "ImgFlowOccFromFolder": ImgFlowOccFromFolder,
}
# the JAX package's registry but for SyntheticInpainting and the three
# inpainting datasets (ROADMAP A10)
DATASET_REGISTRY = {**FILE_DATASETS, "SyntheticFlow": SyntheticFlow,
                    "SyntheticFlowWarp": SyntheticFlowWarp}
