"""Weights and W8A8 scales from the JAX package into the port.

``flownetcv_from_flax`` is the inverse of
``ocflow_tpu.models.torch_convert.convert_flownetcv``: it takes the flax
``params`` of ``FlowNetCV`` / ``PWCNet`` as nested dicts of arrays and
returns the port's ``state_dict``. ``flownetc_from_flax``,
``occnetc_from_flax`` and ``flowoccnetc_from_flax`` are the inverses of
``convert_flownetc``, ``convert_occlusion_net_c`` and
``convert_flow_occ_net_c``: they take ``{"params", "batch_stats"}``; so do
``simpleflownet_from_flax``, ``flownet_from_flax`` and
``flowoccnet_from_flax`` (inverses of ``convert_simpleflownet``,
``convert_flownet_fpn``, ``convert_flow_occ_net_fpn``),
``flownets_from_flax``, ``occnets_from_flax``, ``flowoccnets_from_flax``
(inverses of ``convert_flownets``, ``convert_occlusion_net_s``,
``convert_flow_occ_net_s``, which give the up-deconvs a zero bias where
these carry flax's), ``simpleoccnet_from_flax``,
``simpleflowoccnet_from_flax``, ``eflownet_from_flax`` and
``inpaintingnet_from_flax`` (inverses of ``convert_simple_occlusion_net``,
``convert_simple_flow_occ_net``, ``convert_eflownet``,
``convert_eflownet2`` and ``convert_inpainting_net``), and
``ocflownet_from_flax`` (the two nets of ``OCFlowNet`` under
``SimpleFlowOccNet_0`` and ``InpaintingNet_0``), ``inpaintsanet_from_flax``,
``inpaintsanetorg_from_flax`` and ``discriminator_from_flax`` (the
gated-conv generators and the spectral-norm discriminators, their ``u`` and
``sigma`` too), while
``flowoccnetcv_from_flax`` and ``flowoccnetcv2_from_flax`` (inverses of
``convert_flow_occ_net_cv`` and ``convert_flow_occ_net_cv2``) take
``params``, as those nets have no BatchNorm. Conventions:

- flax ``nn.Conv`` HWIO -> torch ``Conv2d`` OIHW;
- flax ``nn.ConvTranspose`` HWIO -> torch ``ConvTranspose2d`` (I, O, kH, kW)
  with the kernel spatially flipped;
- flax ``nn.BatchNorm`` (``params`` scale, bias; ``batch_stats`` mean, var)
  -> torch ``BatchNorm2d`` (weight, bias, running_mean, running_var; and
  ``num_batches_tracked`` 0, which nothing in eval mode reads);
- values become fp32 tensors, but fp64 ones stay fp64.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ocflow_torch.models.feature_pyramid import CONTEXT as FPN_CONTEXT
from ocflow_torch.models.flow_net_s import LEVELS, S_TRUNK_CONVS, TRUNK_CONVS, FlowNetC, FlowNetS
from ocflow_torch.models.flow_occ_nets import FlowOccNetC, FlowOccNetS
from ocflow_torch.models.gated_conv import COARSE, DIS_WIDTHS, REFINE, UPSAMPLE
from ocflow_torch.models.inpainting_net import DOWN as INPAINT_DOWN
from ocflow_torch.models.inpainting_net import UP as INPAINT_UP
from ocflow_torch.models.occlusion_nets import OcclusionNetC, OcclusionNetS
from ocflow_torch.models.pwc_net import CONTEXT, DECODER_LEVELS, GROWTH, encoder_names
from ocflow_torch.models.simple_flow_net import DOWN, UP


def _arr(a) -> np.ndarray:
    """fp32, or fp64 where the tree is fp64 (an fp64 check's readings)."""
    a = np.asarray(a)
    return a if a.dtype == np.float64 else a.astype(np.float32)


def _conv(sd: dict, name: str, node: Mapping) -> None:
    sd[f"{name}.weight"] = torch.from_numpy(
        np.ascontiguousarray(_arr(node["kernel"]).transpose(3, 2, 0, 1)))
    if "bias" in node:
        sd[f"{name}.bias"] = torch.from_numpy(_arr(node["bias"]).copy())


def _deconv(sd: dict, name: str, node: Mapping) -> None:
    k = _arr(node["kernel"]).transpose(2, 3, 0, 1)  # [I, O, kH, kW], flipped
    sd[f"{name}.weight"] = torch.from_numpy(np.flip(k, (2, 3)).copy())
    sd[f"{name}.bias"] = torch.from_numpy(_arr(node["bias"]).copy())


def _bn(sd: dict, name: str, params: Mapping, stats: Mapping) -> None:
    for key, value in (("weight", params["scale"]), ("bias", params["bias"]),
                       ("running_mean", stats["mean"]), ("running_var", stats["var"])):
        sd[f"{name}.{key}"] = torch.from_numpy(_arr(value).copy())
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0)


def _conv_bn(sd: dict, conv: str, bn: str, params: Mapping, stats: Mapping) -> None:
    """A flax ``ConvBlock(use_bn=True)`` -> the conv ``conv`` and the
    BatchNorm ``bn``."""
    _conv(sd, conv, params["Conv_0"])
    _bn(sd, bn, params["BatchNorm_0"], stats["BatchNorm_0"])


def _encoder(sd: dict, p: Mapping) -> None:
    """FlowNetCV's ``SiameseEncoder_0`` -> ``conv1a.0`` ... ``conv6b.0``."""
    for i, name in enumerate(encoder_names()):
        _conv(sd, f"{name}.0", p["SiameseEncoder_0"][f"ConvBlock_{i}"]["Conv_0"])


def _context(sd: dict, node: Mapping, names: list[str]) -> None:
    """A flax ``ContextNetwork`` (``ConvBlock_0..5``, then ``Conv_0`` or
    ``PredictFlow_0``) -> the seven convs ``names``."""
    for j, name in enumerate(names[:-1]):
        _conv(sd, name, node[f"ConvBlock_{j}"]["Conv_0"])
    head = node["Conv_0"] if "Conv_0" in node else node["PredictFlow_0"]["Conv_0"]
    _conv(sd, names[-1], head)


def flownetcv_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """flax ``params`` (or ``{"params": ...}``) of FlowNetCV -> port
    ``state_dict`` (fp32 CPU tensors)."""
    p = params.get("params", params)
    sd: dict[str, torch.Tensor] = {}
    _encoder(sd, p)
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
    _context(sd, p["ContextNetwork_0"],
             [f"dc_conv{j + 1}.0" for j in range(len(CONTEXT))] + [f"dc_conv{len(CONTEXT) + 1}"])
    return sd


def _fnetc_family_from_flax(variables: Mapping, heads: tuple[str, ...],
                            trunk: str = "C", encoder: str | None = None) -> dict:
    """The FlowNetC family (``models.flow_net_s.FlowNetCFamily`` with
    ``heads``) from flax ``{"params", "batch_stats"}``, in the flax creation
    order: ``ConvBlock_0..10`` (conv1, conv2, conv3, conv_redir, conv3_1,
    conv4 ... conv6_1); per level 6..2 ``PredictFlow_i`` / ``PredictOcc_i``;
    per level 6..3 the heads' up-deconvs, then the feature deconv, as
    ``Deconv_k`` in that order. ``trunk="S"`` reads the FlowNetS family's
    ``ConvBlock_0..9`` (conv1, conv2, conv3, conv3_1 ... conv6_1), under the
    node ``encoder`` when given (``_FNetSEncoder_0``)."""
    p = variables["params"]
    stats = variables.get("batch_stats", {})
    enc_p = p[encoder] if encoder else p
    enc_s = stats.get(encoder, {}) if encoder else stats
    rest = TRUNK_CONVS if trunk == "C" else S_TRUNK_CONVS
    names = ["conv1", "conv2", "conv3"] + [n for n, *_ in rest]
    sd: dict[str, torch.Tensor] = {}
    for i, name in enumerate(names):
        block = enc_p[f"ConvBlock_{i}"]
        _conv(sd, f"{name}.0", block["Conv_0"])
        if "BatchNorm_0" in block:
            _bn(sd, f"{name}.1", block["BatchNorm_0"], enc_s[f"ConvBlock_{i}"]["BatchNorm_0"])
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


def flownets_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of FlowNetS -> port
    ``state_dict`` (the up-deconvs' biases included)."""
    return _fnetc_family_from_flax(variables, FlowNetS.HEADS, trunk="S")


def occnets_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of OcclusionNetS -> port
    ``state_dict``."""
    return _fnetc_family_from_flax(variables, OcclusionNetS.HEADS, trunk="S",
                                   encoder="_FNetSEncoder_0")


def flowoccnets_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of FlowOccNetS -> port
    ``state_dict``."""
    return _fnetc_family_from_flax(variables, FlowOccNetS.HEADS, trunk="S",
                                   encoder="_FNetSEncoder_0")


def _stack(sd: dict, name: str, node: Mapping) -> None:
    """A flax ``PredictFlowStack`` / ``PredictOccStack`` -> ``<name>.0.0``,
    ``.1.0``, ``.2.0``."""
    _conv(sd, f"{name}.0.0", node["ConvBlock_0"]["Conv_0"])
    _conv(sd, f"{name}.1.0", node["ConvBlock_1"]["Conv_0"])
    _conv(sd, f"{name}.2.0", node["Conv_0"])


def _proj_blocks(sd: dict, p: Mapping, st: Mapping, n_up: int) -> None:
    """``ProjDown_i`` / ``ProjUp_i`` -> ``down<i+1>`` / ``up<i+1>``
    (``ConvBlock_j`` -> ``conv<j+1>``, ``bn<j+1>``)."""
    for flax_name, name, n in (("ProjDown", "down", len(DOWN)), ("ProjUp", "up", n_up)):
        for i in range(n):
            for j in range(3):
                node = f"{flax_name}_{i}"
                _conv_bn(sd, f"{name}{i + 1}.conv{j + 1}", f"{name}{i + 1}.bn{j + 1}",
                         p[node][f"ConvBlock_{j}"], st[node][f"ConvBlock_{j}"])


def simpleflownet_from_flax(variables: Mapping, head: str = "flow") -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of SimpleFlowNet -> port
    ``state_dict``: ``ProjDown_i`` / ``ProjUp_i`` -> ``down<i+1>`` /
    ``up<i+1>`` (``ConvBlock_j`` -> ``conv<j+1>``, ``bn<j+1>``),
    ``PredictFlowStack_i`` -> ``predict_flow<5-i>`` (``head="occ"``:
    SimpleOcclusionNet's ``PredictOccStack_i`` -> ``predict_occ<5-i>``)."""
    p, st = variables["params"], variables["batch_stats"]
    sd: dict[str, torch.Tensor] = {}
    _proj_blocks(sd, p, st, len(UP))
    flax_head = "PredictFlowStack" if head == "flow" else "PredictOccStack"
    for i in range(len(UP) + 1):
        _stack(sd, f"predict_{head}{len(UP) - i}", p[f"{flax_head}_{i}"])
    return sd


def simpleoccnet_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of SimpleOcclusionNet -> port
    ``state_dict``."""
    return simpleflownet_from_flax(variables, head="occ")


def simpleflowoccnet_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of SimpleFlowOccNet -> port
    ``state_dict``: four up blocks; ``PredictFlowStack_i`` /
    ``PredictOccStack_i`` -> ``predict_flow<5-i>`` / ``predict_occ<5-i>``."""
    p, st = variables["params"], variables["batch_stats"]
    sd: dict[str, torch.Tensor] = {}
    _proj_blocks(sd, p, st, len(UP) - 1)
    for i in range(len(UP)):
        _stack(sd, f"predict_flow{len(UP) - i}", p[f"PredictFlowStack_{i}"])
        _stack(sd, f"predict_occ{len(UP) - i}", p[f"PredictOccStack_{i}"])
    return sd


def inpaintingnet_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of InpaintingNet -> port
    ``state_dict``: ``_Down_i`` / ``_Up_i`` -> ``down<i+1>`` / ``up<i+1>``
    (``ConvBlock_j`` -> ``conv<j+1>``, ``bn<j+1>``; the last up block's
    third conv has no BatchNorm)."""
    p, st = variables["params"], variables["batch_stats"]
    sd: dict[str, torch.Tensor] = {}
    for flax_name, name, n in (("_Down", "down", len(INPAINT_DOWN)),
                               ("_Up", "up", len(INPAINT_UP))):
        for i in range(n):
            node = f"{flax_name}_{i}"
            for j in range(3):
                block = p[node][f"ConvBlock_{j}"]
                _conv(sd, f"{name}{i + 1}.conv{j + 1}", block["Conv_0"])
                if "BatchNorm_0" in block:
                    _bn(sd, f"{name}{i + 1}.bn{j + 1}", block["BatchNorm_0"],
                        st[node][f"ConvBlock_{j}"]["BatchNorm_0"])
    return sd


def ocflownet_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of OCFlowNet -> port
    ``state_dict``: ``SimpleFlowOccNet_0`` -> ``flow_occ.*``,
    ``InpaintingNet_0`` -> ``inpaint.*``."""
    p, st = variables["params"], variables["batch_stats"]
    sd: dict[str, torch.Tensor] = {}
    for flax_name, prefix, fn in (("SimpleFlowOccNet_0", "flow_occ", simpleflowoccnet_from_flax),
                                  ("InpaintingNet_0", "inpaint", inpaintingnet_from_flax)):
        part = fn({"params": p[flax_name], "batch_stats": st[flax_name]})
        sd.update({f"{prefix}.{k}": v for k, v in part.items()})
    return sd


def _gated_block(sd: dict, name: str, p: Mapping, st: Mapping, projected: bool) -> None:
    """A flax ``GatedConv`` -> the port's ``<name>.conv2d``,
    ``<name>.mask_conv2d`` (``_ProjConv_0``, ``_ProjConv_1`` with their
    ``_Conv_j`` -> ``conv<j+1>``; or ``_Conv_0``, ``_Conv_1``) and its
    BatchNorm (``batch_norm``, or ``batch_norm2d`` under plain towers)."""
    for t, tower in enumerate(("conv2d", "mask_conv2d")):
        if projected:
            for j in range(3):
                _conv(sd, f"{name}.{tower}.conv{j + 1}", p[f"_ProjConv_{t}"][f"_Conv_{j}"]["Conv_0"])
        else:
            _conv(sd, f"{name}.{tower}", p[f"_Conv_{t}"]["Conv_0"])
    bn = "batch_norm" if projected else "batch_norm2d"
    _bn(sd, f"{name}.{bn}", p["BatchNorm_0"], st["BatchNorm_0"])


def _inpaintsanet_from_flax(variables: Mapping, projected: bool) -> dict[str, torch.Tensor]:
    p, st = variables["params"], variables["batch_stats"]
    sd: dict[str, torch.Tensor] = {}
    for flax_name, name, spec in (("_GeneratorTrunk_0", "coarse_net", COARSE),
                                  ("_RefineTrunk_0", "refine_conv_net", REFINE),
                                  ("_RefineUpsample_0", "refine_upsample_net", UPSAMPLE)):
        seen = {"GatedConv": 0, "GatedDeConv": 0}
        for i, (_, *conv) in enumerate(spec):
            kind = "GatedDeConv" if conv == [None] else "GatedConv"
            node = f"{kind}_{seen[kind]}"
            seen[kind] += 1
            bp, bs, prefix = p[flax_name][node], st[flax_name][node], f"{name}.{i}"
            if kind == "GatedDeConv":
                bp, bs, prefix = bp["GatedConv_0"], bs["GatedConv_0"], f"{prefix}.conv2d"
            _gated_block(sd, prefix, bp, bs, projected)
    attn = p["SelfAttention_0"]
    for j, conv in enumerate(("query_conv", "key_conv", "value_conv")):
        _conv(sd, f"refine_attn.{conv}", attn[f"Conv_{j}"])
    sd["refine_attn.gamma"] = torch.from_numpy(_arr(attn["gamma"]).copy())
    return sd


def inpaintsanet_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of InpaintSANet -> port
    ``state_dict``: ``_GeneratorTrunk_0``, ``_RefineTrunk_0``,
    ``_RefineUpsample_0`` -> ``coarse_net``, ``refine_conv_net``,
    ``refine_upsample_net`` (their ``GatedConv_k`` and ``GatedDeConv_k``
    counted apart, in the trunk's order; a deconv's ``GatedConv_0`` ->
    ``<i>.conv2d``), ``SelfAttention_0`` (``Conv_0..2``, ``gamma``) ->
    ``refine_attn`` (``query_conv``, ``key_conv``, ``value_conv``,
    ``gamma``)."""
    return _inpaintsanet_from_flax(variables, projected=True)


def inpaintsanetorg_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of InpaintSANetOrg -> port
    ``state_dict``, as :func:`inpaintsanet_from_flax` with plain towers."""
    return _inpaintsanet_from_flax(variables, projected=False)


def _sn_conv(sd: dict, name: str, p: Mapping, st: Mapping) -> None:
    """A flax ``_Conv`` with spectral norm -> the port's ``SNConv2d``: its
    ``Conv_0`` kernel and bias, and ``SpectralNorm_0``'s
    ``Conv_0/kernel/u`` and ``Conv_0/kernel/sigma`` -> ``u``, ``sigma``."""
    _conv(sd, name, p["Conv_0"])
    sn = st["SpectralNorm_0"]
    sd[f"{name}.u"] = torch.from_numpy(_arr(sn["Conv_0/kernel/u"]).copy())
    sd[f"{name}.sigma"] = torch.from_numpy(_arr(sn["Conv_0/kernel/sigma"]).copy())


def discriminator_from_flax(variables: Mapping, projected: bool = True) -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of InpaintSADiscriminator (or,
    with ``projected`` false, InpaintSADiscriminatorOrg) -> port
    ``state_dict``: ``_ProjConv_i`` (``_Conv_j`` -> ``conv<j+1>``) or
    ``_Conv_i`` -> ``discriminator_net.<i>.conv2d``, with each spectral
    norm's ``u`` and ``sigma``."""
    p, st = variables["params"], variables["batch_stats"]
    sd: dict[str, torch.Tensor] = {}
    for i in range(len(DIS_WIDTHS) - 1):
        name = f"discriminator_net.{i}.conv2d"
        if projected:
            for j in range(3):
                _sn_conv(sd, f"{name}.conv{j + 1}", p[f"_ProjConv_{i}"][f"_Conv_{j}"],
                         st[f"_ProjConv_{i}"][f"_Conv_{j}"])
        else:
            _sn_conv(sd, name, p[f"_Conv_{i}"], st[f"_Conv_{i}"])
    return sd


def _prelu(sd: dict, name: str, node: Mapping) -> None:
    sd[f"{name}.weight"] = torch.from_numpy(_arr(node["negative_slope"]).reshape(-1).copy())


def _enet_bottleneck(sd: dict, prefix: str, p: Mapping, st: Mapping) -> None:
    """A flax ``BottleNeck`` -> the port's ``<prefix>.*``, its variant read
    off the tree: ``ConvTranspose_0`` (upsample), ``Conv_3`` (asymmetric),
    ``PReLU_*`` (PReLU activations)."""
    def bn(i, name):
        _bn(sd, f"{prefix}.{name}", p[f"BatchNorm_{i}"], st[f"BatchNorm_{i}"])

    def prelu(i, name):
        if f"PReLU_{i}" in p:
            _prelu(sd, f"{prefix}.{name}", p[f"PReLU_{i}"])

    if "ConvTranspose_0" in p:
        _conv(sd, f"{prefix}.spatil_conv", p["Conv_0"])
        bn(0, "bn_up")
        _conv(sd, f"{prefix}.conv1", p["Conv_1"])
        bn(1, "bn1")
        k = _arr(p["ConvTranspose_0"]["kernel"]).transpose(2, 3, 0, 1)
        sd[f"{prefix}.conv2.weight"] = torch.from_numpy(np.flip(k, (2, 3)).copy())
        bn(2, "bn2")
        _conv(sd, f"{prefix}.conv3", p["Conv_2"])
        bn(3, "bn3")
        return
    _conv(sd, f"{prefix}.conv1", p["Conv_0"])
    bn(0, "bn1")
    prelu(0, "prelu1")
    if "Conv_3" in p:
        _conv(sd, f"{prefix}.conv2.0", p["Conv_1"])
        bn(1, "conv2.1")
        prelu(1, "conv2.2")
        _conv(sd, f"{prefix}.conv2.3", p["Conv_2"])
        bn(2, "bn2")
        prelu(2, "prelu2")
        _conv(sd, f"{prefix}.conv3", p["Conv_3"])
        bn(3, "bn3")
        prelu(3, "prelu3")
        prelu(4, "prelu_out")
        return
    _conv(sd, f"{prefix}.conv2", p["Conv_1"])
    bn(1, "bn2")
    prelu(1, "prelu2")
    _conv(sd, f"{prefix}.conv3", p["Conv_2"])
    bn(2, "bn3")
    prelu(2, "prelu3")
    prelu(3, "prelu_out")


# the port's bottleneck names in the flax creation order (BottleNeck_i)
_ENET_ENCODER = (["bottleneck10"] + [f"bottleneck1{i}" for i in range(1, 5)]
                 + ["bottleneck20"] + [f"bottleneck{s}{i}" for s in (2, 3) for i in range(1, 9)])
_ENET_DECODER = ("bottleneck40", "bottleneck41", "bottleneck42", "bottleneck50",
                 "bottleneck51")


def eflownet_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of EFlowNet or EFlowNet2 -> port
    ``state_dict``: ``_ENetEncoder_0`` (``InitialBlock_0`` -> ``initial``,
    ``BottleNeck_i`` -> ``bottleneck10`` ... ``bottleneck38``), the
    decoder's ``BottleNeck_i`` -> ``bottleneck40`` ... ``bottleneck51``,
    ``PredictFlow_0`` -> ``predict_flow`` (EFlowNet) or ``PredictFlow_0..2``
    -> ``predict_flow3..5`` (EFlowNet2)."""
    p, st = variables["params"], variables["batch_stats"]
    sd: dict[str, torch.Tensor] = {}
    enc_p, enc_s = p["_ENetEncoder_0"], st["_ENetEncoder_0"]
    init = enc_p["InitialBlock_0"]
    _conv(sd, "initial.conv", init["Conv_0"])
    _bn(sd, "initial.bn", init["BatchNorm_0"], enc_s["InitialBlock_0"]["BatchNorm_0"])
    sd["initial.prelu.weight"] = torch.from_numpy(
        _arr(init["ChannelPReLU_0"]["negative_slope"]).copy())
    for i, name in enumerate(_ENET_ENCODER):
        _enet_bottleneck(sd, name, enc_p[f"BottleNeck_{i}"], enc_s[f"BottleNeck_{i}"])
    for i, name in enumerate(_ENET_DECODER):
        _enet_bottleneck(sd, name, p[f"BottleNeck_{i}"], st[f"BottleNeck_{i}"])
    if "PredictFlow_1" in p:
        for i in range(3):
            _conv(sd, f"predict_flow{3 + i}", p[f"PredictFlow_{i}"]["Conv_0"])
    else:
        _conv(sd, "predict_flow", p["PredictFlow_0"]["Conv_0"])
    return sd


def _fpn_from_flax(sd: dict, p: Mapping, st: Mapping) -> None:
    """``FeaturePyramidNet_0`` -> ``feature_pyramid_network.*``."""
    pre = "feature_pyramid_network"
    for i in range(6):
        node = f"DoubleConv_{i}"
        for j, (ci, bi) in enumerate(((0, 1), (3, 4))):
            _conv_bn(sd, f"{pre}.layer{i + 1}.double_conv.{ci}",
                     f"{pre}.layer{i + 1}.double_conv.{bi}", p[node][f"ConvBlock_{j}"],
                     st[node][f"ConvBlock_{j}"])
    _conv_bn(sd, f"{pre}.pyr_top.0", f"{pre}.pyr_top.1", p["ConvBlock_0"], st["ConvBlock_0"])
    for i, lvl in enumerate((5, 4, 3, 2)):
        node = f"FPNUp_{i}"
        _deconv(sd, f"{pre}.upsample{lvl}.deconv", p[node]["ConvTranspose_0"])
        _bn(sd, f"{pre}.upsample{lvl}.batchnorm", p[node]["BatchNorm_0"],
            st[node]["BatchNorm_0"])


def _estimators_from_flax(sd: dict, p: Mapping, flax_name: str, prefix: str,
                          names: list[str], head: str) -> None:
    """``<flax_name>_0..4`` -> ``<prefix>.{0..4}``: the tower ``names``, the
    head and, but for the finest level, ``upconv1`` / ``upconv2``."""
    for i in range(5):
        node, pre = p[f"{flax_name}_{i}"], f"{prefix}.{i}"
        for j, name in enumerate(names):
            _conv(sd, f"{pre}.{name}", node[f"ConvBlock_{j}"]["Conv_0"])
        _conv(sd, f"{pre}.{head}", node["Conv_0"])
        if i < 4:
            _deconv(sd, f"{pre}.upconv1", node["ConvTranspose_0"])
            _deconv(sd, f"{pre}.upconv2", node["ConvTranspose_1"])


_FLOW_TOWER = ([f"conv{j}" for j in range(1, 6)], "conv6")
_OCC_TOWER = (["conv1", "conv2", "conv3", "conv4", "feat_layer"], "mask_layer")
_FPN_CONTEXT = [f"context_network.conv{j}" for j in range(1, len(FPN_CONTEXT) + 2)]


def flownet_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of the FPN FlowNet -> port
    ``state_dict``."""
    p, st = variables["params"], variables["batch_stats"]
    sd: dict[str, torch.Tensor] = {}
    _fpn_from_flax(sd, p["FeaturePyramidNet_0"], st["FeaturePyramidNet_0"])
    _estimators_from_flax(sd, p, "OpticalFlowEstimator", "opticalflow_estimators",
                          *_FLOW_TOWER)
    _context(sd, p["ContextNetwork_0"], _FPN_CONTEXT)
    return sd


def flowoccnet_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of the FPN FlowOccNet -> port
    ``state_dict``."""
    sd = flownet_from_flax(variables)
    _estimators_from_flax(sd, variables["params"], "OcclusionEstimator",
                          "occlusion_estimators", *_OCC_TOWER)
    return sd


def _flowoccnetcv_from_flax(params: Mapping, separate: bool) -> dict[str, torch.Tensor]:
    p = params.get("params", params)
    sd: dict[str, torch.Tensor] = {}
    _encoder(sd, p)
    flax_dec = "_SeparateFlowOccDecoder" if separate else "_DenseFlowOccDecoder"
    towers = (("fe", 0), ("oe", len(GROWTH))) if separate else (("conv", 0),)
    for i, lvl in enumerate(DECODER_LEVELS):
        dec = p[f"{flax_dec}_{i}"]
        for prefix, base in towers:
            for j in range(len(GROWTH)):
                _conv(sd, f"{prefix}{lvl}_{j}.0", dec[f"ConvBlock_{base + j}"]["Conv_0"])
        _conv(sd, f"predict_flow{lvl}", dec["PredictFlow_0"]["Conv_0"])
        _conv(sd, f"predict_occ{lvl}.0", dec["PredictOcc_0"]["Conv_0"])
        if lvl > DECODER_LEVELS[-1]:
            for k, name in enumerate(("upflow", "upocc", "upfeat")):
                _deconv(sd, f"{name}{lvl}", p[f"Deconv_{3 * i + k}"]["ConvTranspose_0"])
    _context(sd, p["ContextNetwork_0"],
             [f"dc_conv{j + 1}.0" for j in range(len(CONTEXT))] + [f"dc_conv{len(CONTEXT) + 1}"])
    return sd


def flowoccnetcv_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """flax ``params`` (or ``{"params": ...}``) of FlowOccNetCV (``pwoc``)
    -> port ``state_dict``."""
    return _flowoccnetcv_from_flax(params, separate=False)


def flowoccnetcv2_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """flax ``params`` (or ``{"params": ...}``) of FlowOccNetCV2 (``pwoc2``)
    -> port ``state_dict``."""
    return _flowoccnetcv_from_flax(params, separate=True)


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


def pair_from_flax(variables: Mapping, **bridges) -> dict[str, torch.Tensor]:
    """flax ``{"params": {name: ...}, "batch_stats": {name: ...}}`` of a
    pipeline's nets -> the ``state_dict`` of ``nn.ModuleDict({name: net})``:
    each part through its bridge (``bridges[name]``, given the part's
    ``{"params", "batch_stats"}``), its keys under ``<name>.``."""
    p, st = variables["params"], variables.get("batch_stats") or {}
    sd: dict[str, torch.Tensor] = {}
    for name, fn in bridges.items():
        part = fn({"params": p[name], "batch_stats": st.get(name) or {}})
        sd.update({f"{name}.{k}": v for k, v in part.items()})
    return sd


def two_stage_from_flax(variables: Mapping, inpaint=None) -> dict[str, torch.Tensor]:
    """The TwoStageModelGC state's ``{"params", "batch_stats"}`` (``occ``:
    SimpleOcclusionNet, ``inpaint``: the inpainter, by default
    InpaintingNet; pass its bridge, e.g. :func:`inpaintsanet_from_flax`) ->
    the ``state_dict`` of ``nn.ModuleDict({'occ', 'inpaint'})``."""
    return pair_from_flax(variables, occ=simpleoccnet_from_flax,
                          inpaint=inpaint or inpaintingnet_from_flax)


def joint_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """The joint step's ``{"params", "batch_stats"}`` (``flow_occ``:
    FlowOccNetCV, ``inpaint``: InpaintingNet) -> the ``state_dict`` of
    ``nn.ModuleDict({'flow_occ', 'inpaint'})``."""
    return pair_from_flax(variables, flow_occ=flowoccnetcv_from_flax,
                          inpaint=inpaintingnet_from_flax)


def vgg16_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """flax ``params`` (or ``{"params": ...}``) of ``VGG16Features``
    (``Conv_0..Conv_9``) -> the port's ``state_dict`` (torchvision's
    ``features.<index>``)."""
    from ocflow_torch.losses.perceptual import VGG16Features

    p = params.get("params", params)
    sd: dict[str, torch.Tensor] = {}
    convs = [i for i, m in enumerate(VGG16Features().features) if isinstance(m, torch.nn.Conv2d)]
    for j, idx in enumerate(convs):
        _conv(sd, f"features.{idx}", p[f"Conv_{j}"])
    return sd


def inception_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """flax ``{"params", "batch_stats"}`` of InceptionV3 -> the port's
    ``state_dict`` (torchvision's names): ``BasicConv_i`` of the stem and
    each block's ``BasicConv_j`` in the branch order of
    ``metrics.inception.TORCH_BRANCHES``, ``Dense_0`` -> ``fc``. A missing
    tensor raises ``KeyError``."""
    from ocflow_torch.metrics.inception import TORCH_BRANCHES, TORCH_MIXED, TORCH_STEM

    p, st = variables["params"], variables["batch_stats"]
    sd: dict[str, torch.Tensor] = {}

    def basic(name: str, node: Mapping, stats: Mapping) -> None:
        _conv(sd, f"{name}.conv", node["Conv_0"])
        _bn(sd, f"{name}.bn", node["BatchNorm_0"], stats["BatchNorm_0"])

    for tname, fname in TORCH_STEM:
        basic(tname, p[fname], st[fname])
    for tname, fname in TORCH_MIXED:
        for i, branch in enumerate(TORCH_BRANCHES[fname.rsplit("_", 1)[0]]):
            basic(f"{tname}.{branch}", p[fname][f"BasicConv_{i}"], st[fname][f"BasicConv_{i}"])
    sd["fc.weight"] = torch.from_numpy(np.ascontiguousarray(_arr(p["Dense_0"]["kernel"]).T))
    sd["fc.bias"] = torch.from_numpy(_arr(p["Dense_0"]["bias"]).copy())
    return sd
