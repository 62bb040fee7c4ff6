"""Weights and W8A8 scales from the JAX package into the port.

``flownetcv_from_flax`` is the inverse of
``ocflow_tpu.models.torch_convert.convert_flownetcv``: it takes the flax
``params`` of ``FlowNetCV`` / ``PWCNet`` as nested dicts of arrays and
returns the port's ``state_dict``. ``flownetc_from_flax``,
``occnetc_from_flax`` and ``flowoccnetc_from_flax`` are the inverses of
``convert_flownetc``, ``convert_occlusion_net_c`` and
``convert_flow_occ_net_c``: they take ``{"params", "batch_stats"}``.
Conventions:

- flax ``nn.Conv`` HWIO -> torch ``Conv2d`` OIHW;
- flax ``nn.ConvTranspose`` HWIO -> torch ``ConvTranspose2d`` (I, O, kH, kW)
  with the kernel spatially flipped;
- flax ``nn.BatchNorm`` (``params`` scale, bias; ``batch_stats`` mean, var)
  -> torch ``BatchNorm2d`` (weight, bias, running_mean, running_var; and
  ``num_batches_tracked`` 0, which nothing in eval mode reads).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ocflow_torch.models.flow_net_s import LEVELS, TRUNK_CONVS, FlowNetC
from ocflow_torch.models.flow_occ_nets import FlowOccNetC
from ocflow_torch.models.occlusion_nets import OcclusionNetC
from ocflow_torch.models.pwc_net import CONTEXT, DECODER_LEVELS, GROWTH, encoder_names


def _arr(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def _conv(sd: dict, name: str, node: Mapping) -> None:
    sd[f"{name}.weight"] = torch.from_numpy(
        np.ascontiguousarray(_arr(node["kernel"]).transpose(3, 2, 0, 1)))
    if "bias" in node:
        sd[f"{name}.bias"] = torch.from_numpy(_arr(node["bias"]).copy())


def _deconv(sd: dict, name: str, node: Mapping) -> None:
    k = _arr(node["kernel"]).transpose(2, 3, 0, 1)  # [I, O, kH, kW], flipped
    sd[f"{name}.weight"] = torch.from_numpy(np.flip(k, (2, 3)).copy())
    sd[f"{name}.bias"] = torch.from_numpy(_arr(node["bias"]).copy())


def flownetcv_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """flax ``params`` (or ``{"params": ...}``) of FlowNetCV -> port
    ``state_dict`` (fp32 CPU tensors)."""
    p = params.get("params", params)
    sd: dict[str, torch.Tensor] = {}
    enc = p["SiameseEncoder_0"]
    for i, name in enumerate(encoder_names()):
        _conv(sd, f"{name}.0", enc[f"ConvBlock_{i}"]["Conv_0"])
    deconv_i = 0
    for dec_i, lvl in enumerate(DECODER_LEVELS):
        dec = p[f"DenseDecoder_{dec_i}"]
        for j in range(len(GROWTH)):
            _conv(sd, f"conv{lvl}_{j}.0", dec[f"ConvBlock_{j}"]["Conv_0"])
        _conv(sd, f"predict_flow{lvl}", dec["PredictFlow_0"]["Conv_0"])
        if lvl > DECODER_LEVELS[-1]:
            _deconv(sd, f"deconv{lvl}",
                    p[f"Deconv_{deconv_i}"]["ConvTranspose_0"])
            _deconv(sd, f"upfeat{lvl}",
                    p[f"Deconv_{deconv_i + 1}"]["ConvTranspose_0"])
            deconv_i += 2
    ctx = p["ContextNetwork_0"]
    for j in range(len(CONTEXT)):
        _conv(sd, f"dc_conv{j + 1}.0", ctx[f"ConvBlock_{j}"]["Conv_0"])
    _conv(sd, f"dc_conv{len(CONTEXT) + 1}", ctx["PredictFlow_0"]["Conv_0"])
    return sd


def _fnetc_family_from_flax(variables: Mapping, heads: tuple[str, ...]) -> dict:
    """The FlowNetC family (``models.flow_net_s.FlowNetCFamily`` with
    ``heads``) from flax ``{"params", "batch_stats"}``, in the flax creation
    order: ``ConvBlock_0..10`` (conv1, conv2, conv3, conv_redir, conv3_1,
    conv4 ... conv6_1); per level 6..2 ``PredictFlow_i`` / ``PredictOcc_i``;
    per level 6..3 the heads' up-deconvs, then the feature deconv, as
    ``Deconv_k`` in that order."""
    p = variables["params"]
    stats = variables.get("batch_stats", {})
    names = ["conv1", "conv2", "conv3"] + [n for n, *_ in TRUNK_CONVS]
    sd: dict[str, torch.Tensor] = {}
    for i, name in enumerate(names):
        block = p[f"ConvBlock_{i}"]
        _conv(sd, f"{name}.0", block["Conv_0"])
        if "BatchNorm_0" in block:
            bn, st = block["BatchNorm_0"], stats[f"ConvBlock_{i}"]["BatchNorm_0"]
            for key, value in (("weight", bn["scale"]), ("bias", bn["bias"]),
                               ("running_mean", st["mean"]), ("running_var", st["var"])):
                sd[f"{name}.1.{key}"] = torch.from_numpy(_arr(value).copy())
            sd[f"{name}.1.num_batches_tracked"] = torch.tensor(0)
    flax_head = {"flow": "PredictFlow", "occ": "PredictOcc"}
    for i, lvl in enumerate(LEVELS):
        for h in heads:
            _conv(sd, f"predict_{h}{lvl}" + (".0" if h == "occ" else ""),
                  p[f"{flax_head[h]}_{i}"]["Conv_0"])
        if lvl == LEVELS[-1]:
            break
        base = (len(heads) + 1) * i
        for j, h in enumerate(heads):
            _deconv(sd, f"upsampled_{h}{lvl}_to_{lvl - 1}",
                    p[f"Deconv_{base + j}"]["ConvTranspose_0"])
        _deconv(sd, f"deconv{lvl - 1}.0",
                p[f"Deconv_{base + len(heads)}"]["ConvTranspose_0"])
    return sd


def flownetc_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of FlowNetC -> port ``state_dict``
    (fp32 CPU tensors, BatchNorm statistics included)."""
    return _fnetc_family_from_flax(variables, FlowNetC.HEADS)


def occnetc_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of OcclusionNetC -> port
    ``state_dict``."""
    return _fnetc_family_from_flax(variables, OcclusionNetC.HEADS)


def flowoccnetc_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of FlowOccNetC -> port
    ``state_dict``."""
    return _fnetc_family_from_flax(variables, FlowOccNetC.HEADS)


def q8_scales_from_numpy(tree: Mapping) -> dict:
    """W8A8 scales of the JAX package's ``calibrate_q8`` (``{'dec0': {'in':
    s, 'growth': [s] * 5}, ..., 'dec4': ..., optional 'enc', 'ctx'}`` with
    numpy scalars or 0-d arrays) -> the port's form for
    ``fast_apply(..., q8=...)``: the same tree with every scale a Python
    float holding the fp32 value."""
    def conv(v):
        if isinstance(v, Mapping):
            return {k: conv(e) for k, e in v.items()}
        if isinstance(v, (list, tuple)):
            return [conv(e) for e in v]
        return float(np.float32(np.asarray(v)))
    return conv(tree)
