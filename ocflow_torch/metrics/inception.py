"""InceptionV3 feature extractor for FID and the Inception Score (port of
``ocflow_tpu/metrics/inception.py``, itself of pytorch-fid's network).

The torchvision architecture with its module names (``Conv2d_1a_3x3``,
``Mixed_5b.branch1x1``, ..., ``fc``), NCHW inside, NHWC in. With
``fid_variant`` it is pytorch-fid's network: 1008 classes, average pools
that leave the padding out of the count (``count_include_pad=False``) in
the A and C blocks and the first E block, and a max pool in the last E
block. Every BasicConv's BatchNorm (eps 1e-3) uses its running statistics,
in any mode.

:func:`init_inception` seeds the net (the convs and the classifier from
flax's truncated LeCun-normal, zero biases, BatchNorm at the identity) or
loads, strictly, the JAX package's ``.npz`` ('/'-joined flax paths,
``params/...`` and ``batch_stats/...``) that :func:`convert_torch_inception`
writes from a torchvision or pytorch-fid state_dict. Without weights the
features are random: relative comparisons only.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ocflow_torch import full_fp32_convs
from ocflow_torch.models.common import TRUNC_STD


def _pair(p):
    return (p, p) if isinstance(p, int) else p


class BasicConv(nn.Module):
    """Conv (no bias), BatchNorm (eps 1e-3, running statistics), ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=_pair(padding),
                              bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        bn = self.bn
        x = F.batch_norm(self.conv(x), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                         False, 0.0, bn.eps)
        return F.relu(x)


def _avg_pool3(x, count_include_pad: bool = True):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=count_include_pad)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int, fid_pool: bool = False):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 64, 1)
        self.branch5x5_1 = BasicConv(cin, 48, 1)
        self.branch5x5_2 = BasicConv(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, padding=1)
        self.branch_pool = BasicConv(cin, pool_features, 1)
        self.fid_pool = fid_pool

    def forward(self, x):
        b2 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        b4 = self.branch_pool(_avg_pool3(x, not self.fid_pool))
        return torch.cat([self.branch1x1(x), b2, b3, b4], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv(96, 96, 3, stride=2)

    def forward(self, x):
        b2 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), b2, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int, fid_pool: bool = False):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 192, 1)
        self.branch7x7_1 = BasicConv(cin, c7, 1)
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv(cin, 192, 1)
        self.fid_pool = fid_pool

    def forward(self, x):
        b2 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        b3 = x
        for j in range(1, 6):
            b3 = getattr(self, f"branch7x7dbl_{j}")(b3)
        b4 = self.branch_pool(_avg_pool3(x, not self.fid_pool))
        return torch.cat([self.branch1x1(x), b2, b3, b4], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv(cin, 192, 1)
        self.branch3x3_2 = BasicConv(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv(192, 192, 3, stride=2)

    def forward(self, x):
        b2 = x
        for j in range(1, 5):
            b2 = getattr(self, f"branch7x7x3_{j}")(b2)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b2, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    """``pool``: ``avg`` (torchvision), ``fid_avg`` (pytorch-fid's first E
    block, the padding left out of the count), ``max`` (its last)."""

    def __init__(self, cin: int, pool: str = "avg"):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 320, 1)
        self.branch3x3_1 = BasicConv(cin, 384, 1)
        self.branch3x3_2a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv(cin, 192, 1)
        self.pool = pool

    def forward(self, x):
        b2 = self.branch3x3_1(x)
        b2 = torch.cat([self.branch3x3_2a(b2), self.branch3x3_2b(b2)], 1)
        b3 = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        b3 = torch.cat([self.branch3x3dbl_3a(b3), self.branch3x3dbl_3b(b3)], 1)
        if self.pool == "max":
            pooled = F.max_pool2d(x, 3, 1, 1)
        else:
            pooled = _avg_pool3(x, self.pool != "fid_avg")
        return torch.cat([self.branch1x1(x), b2, b3, self.branch_pool(pooled)], 1)


# torchvision / pytorch-fid module names <-> the flax modules, in graph order
TORCH_STEM = (("Conv2d_1a_3x3", "BasicConv_0"), ("Conv2d_2a_3x3", "BasicConv_1"),
              ("Conv2d_2b_3x3", "BasicConv_2"), ("Conv2d_3b_1x1", "BasicConv_3"),
              ("Conv2d_4a_3x3", "BasicConv_4"))
TORCH_MIXED = (("Mixed_5b", "InceptionA_0"), ("Mixed_5c", "InceptionA_1"),
               ("Mixed_5d", "InceptionA_2"), ("Mixed_6a", "InceptionB_0"),
               ("Mixed_6b", "InceptionC_0"), ("Mixed_6c", "InceptionC_1"),
               ("Mixed_6d", "InceptionC_2"), ("Mixed_6e", "InceptionC_3"),
               ("Mixed_7a", "InceptionD_0"), ("Mixed_7b", "InceptionE_0"),
               ("Mixed_7c", "InceptionE_1"))
# each block type's branches in the order flax creates its BasicConv_i
TORCH_BRANCHES = {
    "InceptionA": ("branch1x1", "branch5x5_1", "branch5x5_2", "branch3x3dbl_1",
                   "branch3x3dbl_2", "branch3x3dbl_3", "branch_pool"),
    "InceptionB": ("branch3x3", "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3"),
    "InceptionC": ("branch1x1", "branch7x7_1", "branch7x7_2", "branch7x7_3",
                   "branch7x7dbl_1", "branch7x7dbl_2", "branch7x7dbl_3", "branch7x7dbl_4",
                   "branch7x7dbl_5", "branch_pool"),
    "InceptionD": ("branch3x3_1", "branch3x3_2", "branch7x7x3_1", "branch7x7x3_2",
                   "branch7x7x3_3", "branch7x7x3_4"),
    "InceptionE": ("branch1x1", "branch3x3_1", "branch3x3_2a", "branch3x3_2b",
                   "branch3x3dbl_1", "branch3x3dbl_2", "branch3x3dbl_3a", "branch3x3dbl_3b",
                   "branch_pool"),
}


class InceptionV3(nn.Module):
    """``[B, 299, 299, 3]`` in [-1, 1] -> ``(pool3 features [B, 2048],
    logits [B, num_classes])``. ``fid_variant`` builds pytorch-fid's
    network (the module docstring)."""

    def __init__(self, num_classes: int = 1000, fid_variant: bool = False):
        super().__init__()
        fid = fid_variant
        self.Conv2d_1a_3x3 = BasicConv(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32, fid)
        self.Mixed_5c = InceptionA(256, 64, fid)
        self.Mixed_5d = InceptionA(288, 64, fid)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, fid)
        self.Mixed_6c = InceptionC(768, 160, fid)
        self.Mixed_6d = InceptionC(768, 160, fid)
        self.Mixed_6e = InceptionC(768, 192, fid)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "fid_avg" if fid else "avg")
        self.Mixed_7c = InceptionE(2048, "max" if fid else "avg")
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x):
        with full_fp32_convs(x.dtype):
            x = x.permute(0, 3, 1, 2)
            x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
            x = F.max_pool2d(x, 3, 2)
            x = F.max_pool2d(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)), 3, 2)
            for name, _ in TORCH_MIXED:
                x = getattr(self, name)(x)
            feats = x.mean((2, 3))
            return feats, self.fc(feats)


def seed_inception(model: InceptionV3, generator: torch.Generator) -> None:
    """flax's default init drawn from ``generator``: each conv's and the
    classifier's weight from LeCun-normal truncated at +-2 std (fan-in
    ``cin * kh * kw``, the classifier's 2048), in the order of
    ``model.modules()``; zero biases; BatchNorm at the identity."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, (nn.Conv2d, nn.Linear)):
                std = 1.0 / math.sqrt(math.prod(m.weight.shape[1:])) / TRUNC_STD
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def init_inception(generator: torch.Generator | None = None, weights_path: str | None = None,
                   fid_variant: bool | None = None, num_classes: int | None = None,
                   device=None) -> InceptionV3:
    """InceptionV3 on ``device`` in eval mode, its parameters without
    gradients. ``fid_variant`` defaults on with weights (the layout
    :func:`convert_torch_inception` writes), ``num_classes`` to 1008 for
    the FID variant, else 1000. Seeded from ``generator`` (default seed 1,
    as the JAX CLI's ``PRNGKey(1)``), then, with ``weights_path``, every
    tensor replaced from the ``.npz``: one missing or of another shape
    raises (no partial load)."""
    from ocflow_torch.models.convert import inception_from_flax

    if fid_variant is None:
        fid_variant = weights_path is not None
    if num_classes is None:
        num_classes = 1008 if fid_variant else 1000
    model = InceptionV3(num_classes=num_classes, fid_variant=fid_variant)
    seed_inception(model, generator or torch.Generator().manual_seed(1))
    if weights_path:
        tree = _unflatten(dict(np.load(weights_path, allow_pickle=True)))
        try:
            sd = inception_from_flax(tree)
        except KeyError as e:
            raise ValueError(f"weights file {weights_path} is missing {e}; refusing a "
                             "partial load") from None
        own = model.state_dict()
        for k, v in sd.items():
            if own[k].shape != v.shape:
                raise ValueError(f"{k}: shape {tuple(v.shape)} != {tuple(own[k].shape)}")
        model.load_state_dict(sd, strict=False)
    model.requires_grad_(False)
    return model.to(device).eval()


def convert_torch_inception(state_dict_path: str, out_path: str) -> None:
    """A torchvision or pytorch-fid InceptionV3 state_dict (``.pth``) ->
    the ``.npz`` of :func:`init_inception` ('/'-joined flax paths). Raises
    if a conv, BatchNorm or classifier tensor is left unconverted
    (``AuxLogits`` and ``num_batches_tracked`` aside)."""
    sd = torch.load(state_dict_path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    out: dict[str, np.ndarray] = {}
    used: set[str] = set()

    def basic_conv(tname: str, fpath: str) -> None:
        names = {"conv.weight": None, "bn.weight": "params/{}/BatchNorm_0/scale",
                 "bn.bias": "params/{}/BatchNorm_0/bias",
                 "bn.running_mean": "batch_stats/{}/BatchNorm_0/mean",
                 "bn.running_var": "batch_stats/{}/BatchNorm_0/var"}
        out[f"params/{fpath}/Conv_0/kernel"] = sd[f"{tname}.conv.weight"].numpy().transpose(
            2, 3, 1, 0)
        for suffix, key in names.items():
            if key is not None:
                out[key.format(fpath)] = sd[f"{tname}.{suffix}"].numpy()
            used.add(f"{tname}.{suffix}")

    for tname, fname in TORCH_STEM:
        basic_conv(tname, fname)
    for tname, fname in TORCH_MIXED:
        for i, branch in enumerate(TORCH_BRANCHES[fname.rsplit("_", 1)[0]]):
            basic_conv(f"{tname}.{branch}", f"{fname}/BasicConv_{i}")
    out["params/Dense_0/kernel"] = sd["fc.weight"].numpy().T
    out["params/Dense_0/bias"] = sd["fc.bias"].numpy()
    used.update(("fc.weight", "fc.bias"))
    leftover = [k for k in sd if k not in used and "num_batches_tracked" not in k
                and not k.startswith("AuxLogits.")]
    if leftover:
        raise ValueError(f"unconverted inception keys: {sorted(leftover)[:10]}")
    np.savez(out_path, **out)
