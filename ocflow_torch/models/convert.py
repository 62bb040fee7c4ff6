"""Weights and W8A8 scales from the JAX package into the port.

``flownetcv_from_flax`` is the inverse of
``ocflow_tpu.models.torch_convert.convert_flownetcv``: it takes the flax
``params`` of ``FlowNetCV`` / ``PWCNet`` as nested dicts of arrays and
returns the port's ``state_dict``. Conventions:

- flax ``nn.Conv`` HWIO -> torch ``Conv2d`` OIHW;
- flax ``nn.ConvTranspose`` HWIO -> torch ``ConvTranspose2d`` (I, O, kH, kW)
  with the kernel spatially flipped.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ocflow_torch.models.pwc_net import CONTEXT, DECODER_LEVELS, GROWTH, encoder_names


def _arr(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def _conv(sd: dict, name: str, node: Mapping) -> None:
    sd[f"{name}.weight"] = torch.from_numpy(
        np.ascontiguousarray(_arr(node["kernel"]).transpose(3, 2, 0, 1)))
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
