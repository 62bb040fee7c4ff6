"""VGG16 perceptual loss (port of ``ocflow_tpu/losses/perceptual.py``).

:class:`VGG16Features` is the first four blocks of torchvision's VGG16
``features`` (the same module indices, so a torchvision state_dict's
``features.*`` loads into it), returning relu1_2, relu2_2, relu3_3 and
relu4_3. :func:`init_vgg16` seeds it from flax's default initializers or
loads the JAX package's ``.npz`` (``conv{i}_kernel`` HWIO, ``conv{i}_bias``,
``i`` = 0..9), which :func:`convert_torch_vgg16` writes from a torchvision
state_dict. Without weights the loss runs on fixed random features, a valid
but weaker perceptual distance, as in the JAX package.
:func:`vgg_perceptual_loss` sums the weighted mean L1 of the four blocks;
the VGG's parameters take no gradient, its inputs do.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ocflow_torch import full_fp32_convs
from ocflow_torch.models.common import init_weights

# torchvision vgg16.features up to relu4_3: channels per conv, "M" = 2x2 max pool
VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512)
# indices in ``features`` of relu1_2, relu2_2, relu3_3, relu4_3
BLOCK_ENDS = (3, 8, 15, 22)
N_CONVS = 10


class VGG16Features(nn.Module):
    """``[B, H, W, 3]`` -> the four block activations (NHWC views).
    ``generator`` seeds the init (:func:`models.common.init_weights`)."""

    def __init__(self, generator: torch.Generator | None = None):
        super().__init__()
        layers, cin = [], 3
        for v in VGG16_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, padding=1), nn.ReLU()]
                cin = v
        self.features = nn.Sequential(*layers)
        if generator is not None:
            init_weights(self, generator)

    def convs(self) -> list[nn.Conv2d]:
        return [m for m in self.features if isinstance(m, nn.Conv2d)]

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        outs = []
        with full_fp32_convs(x.dtype):
            h = x.permute(0, 3, 1, 2)
            for i, layer in enumerate(self.features):
                h = layer(h)
                if i in BLOCK_ENDS:
                    outs.append(h.permute(0, 2, 3, 1))
        return outs


def load_vgg16_npz(model: VGG16Features, weights_path: str) -> None:
    """Load the ``.npz`` layout of :func:`convert_torch_vgg16` into
    ``model`` (HWIO kernels to OIHW)."""
    loaded = np.load(weights_path)
    with torch.no_grad():
        for i, conv in enumerate(model.convs()):
            conv.weight.copy_(torch.from_numpy(
                np.ascontiguousarray(loaded[f"conv{i}_kernel"].transpose(3, 2, 0, 1))))
            conv.bias.copy_(torch.from_numpy(loaded[f"conv{i}_bias"]))


def init_vgg16(generator: torch.Generator | None = None, weights_path: str | None = None,
               device=None) -> VGG16Features:
    """The frozen VGG16 features on ``device`` in eval mode: seeded from
    ``generator`` (default seed 0, as the JAX CLI's ``PRNGKey(0)``), then
    ``weights_path``'s tensors where given. Its parameters take no
    gradient."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = VGG16Features(generator=generator)
    if weights_path:
        load_vgg16_npz(model, weights_path)
    model.requires_grad_(False)
    return model.to(device).eval()


def convert_torch_vgg16(state_dict_path: str, out_path: str) -> None:
    """A torchvision vgg16 state_dict (``.pth``) -> the ``.npz`` layout:
    its first ten convs' OIHW kernels as HWIO ``conv{i}_kernel`` and their
    ``conv{i}_bias``."""
    sd = torch.load(state_dict_path, map_location="cpu")
    out = {}
    idx = sorted((int(k.split(".")[1]) for k in sd
                  if k.startswith("features.") and k.endswith(".weight")))[:N_CONVS]
    for i, j in enumerate(idx):
        out[f"conv{i}_kernel"] = sd[f"features.{j}.weight"].numpy().transpose(2, 3, 1, 0)
        out[f"conv{i}_bias"] = sd[f"features.{j}.bias"].numpy()
    np.savez(out_path, **out)


def vgg_perceptual_loss(vgg: VGG16Features, pred: torch.Tensor, target: torch.Tensor,
                        weights: Sequence[float] = (1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """``sum_i w_i mean(|block_i(pred) - block_i(target)|)`` of ``[B, H, W,
    3]`` images; ``pred`` and ``target`` go through the net together."""
    feats = vgg(torch.cat([pred, target], 0))
    b = pred.shape[0]
    loss = 0.0
    for w, f in zip(weights, feats):
        loss = loss + w * (f[:b] - f[b:]).abs().mean()
    return loss
