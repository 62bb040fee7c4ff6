"""Original torch ``state_dict`` -> flax-layout weight trees (the port's
copy of ``ocflow_tpu/models/torch_convert.py``, numpy and torch only).

The original OCFlow code ships torch checkpoints only: sniklaus PWC-Net
weights (``moduleExtractor.moduleOne...``, renamed ``net...`` at load), and
Lightning training checkpoints whose sub-modules sit under ``model.``,
``flow_pred.``, ``generator.``, ``discriminator.`` or ``occ_pred.``. Each
converter here maps one original network's ``state_dict`` onto the flax
variables tree (nested dicts of numpy arrays) that the JAX package's
converter returns for it, key for key and bit for bit; the bridges of
``ocflow_torch.models.convert`` (``*_from_flax``) then take that tree to
the port's ``state_dict``. ``ocflow_torch.tools.import_weights`` composes
the two, so the port keeps no second key map of the originals.

Conventions:
- torch ``nn.Conv2d``      OIHW  -> flax ``nn.Conv``          HWIO
- torch ``ConvTranspose2d`` IOHW -> flax ``nn.ConvTranspose`` HWIO, kernel
  spatially flipped (torch's transposed conv is the adjoint of its
  cross-correlation; flax's is a fractionally-strided convolution).
- torch ``BatchNorm2d`` (weight, bias, running_mean, running_var) ->
  flax ``nn.BatchNorm`` (params.scale, params.bias, batch_stats.mean,
  batch_stats.var).

Each converter consumes the *entire* state_dict and raises on unknown keys
(modulo documented dead parameters of the originals, e.g. FlowNetCV's unused
``deconv2``), so silent name drift is impossible. The docstrings name the
flax modules of the JAX package whose trees these are.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np


def _np(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _conv_kernel(w) -> np.ndarray:
    """OIHW -> HWIO."""
    return _np(w).transpose(2, 3, 1, 0)


def _deconv_kernel(w) -> np.ndarray:
    """torch ConvTranspose2d (I, O, kH, kW) -> flax HWIO with spatial flip."""
    w = _np(w)
    return np.flip(w, (2, 3)).transpose(2, 3, 0, 1).copy()


class _Consumer:
    """state_dict view that tracks which keys were used."""

    def __init__(self, sd: Mapping[str, object]):
        self.sd = dict(sd)
        self.used: set[str] = set()

    def take(self, key: str):
        self.used.add(key)
        return self.sd[key]

    def has(self, key: str) -> bool:
        return key in self.sd

    def finish(self, allow_unused: tuple[str, ...] = ()) -> None:
        leftover = [
            k
            for k in self.sd
            if k not in self.used
            and not any(k.startswith(p) for p in allow_unused)
            and "num_batches_tracked" not in k
        ]
        if leftover:
            raise ValueError(f"unconverted torch keys: {sorted(leftover)[:10]}")


def _conv(sd: _Consumer, name: str, bias: bool = True) -> dict:
    """bias=False ⇒ the flax conv has no bias param either (BN follows)."""
    out = {"kernel": _conv_kernel(sd.take(f"{name}.weight"))}
    if bias:
        out["bias"] = _np(sd.take(f"{name}.bias"))
    return out


def _deconv(sd: _Consumer, name: str, bias: bool = True) -> dict:
    out = {"kernel": _deconv_kernel(sd.take(f"{name}.weight"))}
    if bias:
        out["bias"] = _np(sd.take(f"{name}.bias"))
    else:
        out["bias"] = np.zeros(out["kernel"].shape[-1], np.float32)
    return out


def _bn(sd: _Consumer, name: str) -> tuple[dict, dict]:
    params = {"scale": _np(sd.take(f"{name}.weight")),
              "bias": _np(sd.take(f"{name}.bias"))}
    stats = {"mean": _np(sd.take(f"{name}.running_mean")),
             "var": _np(sd.take(f"{name}.running_var"))}
    return params, stats


def convert_flownetcv(state_dict: Mapping[str, object]) -> dict:
    """Reference FlowNetCV (cost_volume_flow_net.py:22-246) -> flax variables
    for ``ocflow_tpu.models.FlowNetCV`` (no normalization layers -> params
    only)."""
    sd = _Consumer(state_dict)
    params: dict = {}

    # Siamese encoder: per level [a(s2), aa, b]; level 6 declares them as
    # conv6aa(s2), conv6a, conv6b (reference :30-47).
    enc_names = []
    for lvl in range(1, 6):
        enc_names += [f"conv{lvl}a", f"conv{lvl}aa", f"conv{lvl}b"]
    enc_names += ["conv6aa", "conv6a", "conv6b"]
    enc = {
        f"ConvBlock_{i}": {"Conv_0": _conv(sd, f"{n}.0")}
        for i, n in enumerate(enc_names)
    }
    params["SiameseEncoder_0"] = enc

    # Dense decoders at levels 6..2 with their deconv/upfeat pairs
    # (reference :58-104); level 2 has no deconvs (deconv2 is dead weight).
    deconv_i = 0
    for dec_i, lvl in enumerate((6, 5, 4, 3, 2)):
        dec = {
            f"ConvBlock_{j}": {"Conv_0": _conv(sd, f"conv{lvl}_{j}.0")}
            for j in range(5)
        }
        dec["PredictFlow_0"] = {"Conv_0": _conv(sd, f"predict_flow{lvl}")}
        params[f"DenseDecoder_{dec_i}"] = dec
        if lvl > 2:
            params[f"Deconv_{deconv_i}"] = {
                "ConvTranspose_0": _deconv(sd, f"deconv{lvl}")
            }
            params[f"Deconv_{deconv_i + 1}"] = {
                "ConvTranspose_0": _deconv(sd, f"upfeat{lvl}")
            }
            deconv_i += 2

    # Context network dc_conv1..7 (reference :106-112).
    ctx = {
        f"ConvBlock_{j}": {"Conv_0": _conv(sd, f"dc_conv{j + 1}.0")}
        for j in range(6)
    }
    ctx["PredictFlow_0"] = {"Conv_0": _conv(sd, "dc_conv7")}
    params["ContextNetwork_0"] = ctx

    sd.finish(allow_unused=("deconv2.",))
    return {"params": params}


def convert_pwcnet(state_dict: Mapping[str, object]) -> dict:
    """Reference PWCNet (pwc_net.py:34-240, the sniklaus port) -> flax
    variables for ``ocflow_tpu.models.PWCNet``.

    Accepts either the reference's key naming (``netExtractor.netOne.0.w…``)
    or the raw sniklaus URL checkpoint (``moduleExtractor.moduleOne…`` —
    the reference renames module->net at load, pwc_net.py:223), so the only
    pretrained flow weights in the ecosystem load directly."""
    state_dict = {
        k.replace("module", "net") if k.startswith("module") else k: v
        for k, v in state_dict.items()
    }
    sd = _Consumer(state_dict)
    params: dict = {}

    levels = ["netOne", "netTwo", "netThr", "netFou", "netFiv", "netSix"]
    enc = {}
    for lvl, name in enumerate(levels):
        for k, seq_i in enumerate((0, 2, 4)):
            enc[f"ConvBlock_{3 * lvl + k}"] = {
                "Conv_0": _conv(sd, f"netExtractor.{name}.{seq_i}")
            }
    params["SiameseEncoder_0"] = enc

    # Decoder(L) for L=6..2 -> DenseDecoder_0..4. Decoder(L<6) also owns the
    # netUpflow/netUpfeat applied to the PREVIOUS level's outputs
    # (pwc_net.py:116-117,163-164) -> our Deconv pairs created after
    # DenseDecoder_{i} for levels 6..3.
    dec_names = ["netSix", "netFiv", "netFou", "netThr", "netTwo"]
    convs = ["netOne", "netTwo", "netThr", "netFou", "netFiv"]
    for i, dname in enumerate(dec_names):
        dec = {
            f"ConvBlock_{j}": {"Conv_0": _conv(sd, f"{dname}.{cname}.0")}
            for j, cname in enumerate(convs)
        }
        dec["PredictFlow_0"] = {"Conv_0": _conv(sd, f"{dname}.netSix.0")}
        params[f"DenseDecoder_{i}"] = dec
    for i, dname in enumerate(dec_names[1:]):  # netFiv..netTwo own the deconvs
        params[f"Deconv_{2 * i}"] = {
            "ConvTranspose_0": _deconv(sd, f"{dname}.netUpflow")
        }
        params[f"Deconv_{2 * i + 1}"] = {
            "ConvTranspose_0": _deconv(sd, f"{dname}.netUpfeat")
        }

    ctx = {
        f"ConvBlock_{j}": {"Conv_0": _conv(sd, f"netRefiner.netMain.{2 * j}")}
        for j in range(6)
    }
    ctx["PredictFlow_0"] = {"Conv_0": _conv(sd, "netRefiner.netMain.12")}
    params["ContextNetwork_0"] = ctx

    sd.finish()
    return {"params": params}


def convert_flownets(state_dict: Mapping[str, object], use_bn: bool = True) -> dict:
    """Reference FlowNetS (flow_net_s.py:10-108) -> flax variables for
    ``ocflow_tpu.models.FlowNetS``."""
    sd = _Consumer(state_dict)
    params: dict = {}
    stats: dict = {}

    convs = ["conv1", "conv2", "conv3", "conv3_1", "conv4", "conv4_1",
             "conv5", "conv5_1", "conv6", "conv6_1"]
    for i, n in enumerate(convs):
        block = {"Conv_0": _conv(sd, f"{n}.0", bias=not use_bn)}
        if use_bn:
            bn_p, bn_s = _bn(sd, f"{n}.1")
            block["BatchNorm_0"] = bn_p
            stats[f"ConvBlock_{i}"] = {"BatchNorm_0": bn_s}
        params[f"ConvBlock_{i}"] = block

    for i, lvl in enumerate((6, 5, 4, 3, 2)):
        params[f"PredictFlow_{i}"] = {"Conv_0": _conv(sd, f"predict_flow{lvl}")}
    # creation order: up-flow deconv (bias=False in torch) then feature deconv
    pairs = [("upsampled_flow6_to_5", "deconv5"),
             ("upsampled_flow5_to_4", "deconv4"),
             ("upsampled_flow4_to_3", "deconv3"),
             ("upsampled_flow3_to_2", "deconv2")]
    for i, (up, dec) in enumerate(pairs):
        params[f"Deconv_{2 * i}"] = {"ConvTranspose_0": _deconv(sd, up, bias=False)}
        params[f"Deconv_{2 * i + 1}"] = {"ConvTranspose_0": _deconv(sd, f"{dec}.0")}

    sd.finish()
    out = {"params": params}
    if use_bn:
        out["batch_stats"] = stats
    return out


def _proj_block(sd: _Consumer, prefix: str) -> tuple[dict, dict]:
    """Reference Downsample/Upsample (simple_flow_net.py:6-57): three
    conv(bias=False)+BN+LeakyReLU stages -> ProjDown/ProjUp ConvBlock_0..2."""
    params, stats = {}, {}
    for j in range(3):
        bn_p, bn_s = _bn(sd, f"{prefix}.bn{j + 1}")
        params[f"ConvBlock_{j}"] = {
            "Conv_0": _conv(sd, f"{prefix}.conv{j + 1}", bias=False),
            "BatchNorm_0": bn_p,
        }
        stats[f"ConvBlock_{j}"] = {"BatchNorm_0": bn_s}
    return params, stats


def convert_flownetc(state_dict: Mapping[str, object], use_bn: bool = True) -> dict:
    """Reference FlowNetC (flow_net_c.py:11-137) -> flax variables for
    ``ocflow_tpu.models.FlowNetC``.

    The reference net is shape-broken (its correlation is called with the
    default max_disp=4 -> 81 channels against a 473-channel conv3_1,
    flow_net_c.py:23,76); the repo's documented repair pins max_disp=10.
    The converter maps the weights as-is — they are disp-agnostic."""
    sd = _Consumer(state_dict)
    params: dict = {}
    stats: dict = {}

    # flax construction order: enc1..enc3, then redir, conv3_1, conv4..6_1
    convs = ["conv1", "conv2", "conv3", "conv_redir", "conv3_1", "conv4",
             "conv4_1", "conv5", "conv5_1", "conv6", "conv6_1"]
    for i, n in enumerate(convs):
        block = {"Conv_0": _conv(sd, f"{n}.0", bias=not use_bn)}
        if use_bn:
            bn_p, bn_s = _bn(sd, f"{n}.1")
            block["BatchNorm_0"] = bn_p
            stats[f"ConvBlock_{i}"] = {"BatchNorm_0": bn_s}
        params[f"ConvBlock_{i}"] = block

    for i, lvl in enumerate((6, 5, 4, 3, 2)):
        params[f"PredictFlow_{i}"] = {"Conv_0": _conv(sd, f"predict_flow{lvl}")}
    # creation order per level: up-flow deconv (bias=True in torch,
    # flow_net_c.py:44-47) then the feature deconv Sequential
    pairs = [("upsampled_flow6_to_5", "deconv5"),
             ("upsampled_flow5_to_4", "deconv4"),
             ("upsampled_flow4_to_3", "deconv3"),
             ("upsampled_flow3_to_2", "deconv2")]
    for i, (up, dec) in enumerate(pairs):
        params[f"Deconv_{2 * i}"] = {"ConvTranspose_0": _deconv(sd, up)}
        params[f"Deconv_{2 * i + 1}"] = {"ConvTranspose_0": _deconv(sd, f"{dec}.0")}

    sd.finish()
    out = {"params": params}
    if use_bn:
        out["batch_stats"] = stats
    return out


def convert_simpleflownet(state_dict: Mapping[str, object]) -> dict:
    """Reference SimpleFlowNet (simple_flow_net.py:60-141) -> flax variables
    for ``ocflow_tpu.models.SimpleFlowNet``."""
    sd = _Consumer(state_dict)
    params: dict = {}
    stats: dict = {}

    for i in range(5):
        p, s = _proj_block(sd, f"down{i + 1}")
        params[f"ProjDown_{i}"] = p
        stats[f"ProjDown_{i}"] = s
    for i in range(5):
        p, s = _proj_block(sd, f"up{i + 1}")
        params[f"ProjUp_{i}"] = p
        stats[f"ProjUp_{i}"] = s
    # predict_flow5..0 -> PredictFlowStack_0..5; torch Sequential of three
    # conv() wrappers: .0.0 (32ch), .1.0 (16ch), .2.0 (2ch, no act).
    for i, lvl in enumerate((5, 4, 3, 2, 1, 0)):
        params[f"PredictFlowStack_{i}"] = {
            "ConvBlock_0": {"Conv_0": _conv(sd, f"predict_flow{lvl}.0.0")},
            "ConvBlock_1": {"Conv_0": _conv(sd, f"predict_flow{lvl}.1.0")},
            "Conv_0": _conv(sd, f"predict_flow{lvl}.2.0"),
        }

    sd.finish()
    return {"params": params, "batch_stats": stats}


def _prelu(sd: _Consumer, name: str):
    """torch nn.PReLU() (1 shared slope) -> flax nn.PReLU scalar param."""
    w = _np(sd.take(f"{name}.weight"))
    assert w.shape == (1,), w.shape
    return {"negative_slope": np.float32(w[0])}


def _enet_bottleneck(sd: _Consumer, prefix: str, *, downsample=False,
                     upsample=False, asymmetric=False, use_prelu=True
                     ) -> tuple[dict, dict]:
    """Reference ENet BottleNeck (efficient_flow_net.py:25-146) -> the flax
    ``BottleNeck``'s param/stat trees, per variant (construction order
    documented in the flax module)."""
    params: dict = {}
    stats: dict = {}

    def bn(i, name):
        p, s = _bn(sd, name)
        params[f"BatchNorm_{i}"] = p
        stats[f"BatchNorm_{i}"] = s

    def prelu(i, name):
        if use_prelu:
            params[f"PReLU_{i}"] = _prelu(sd, name)

    if upsample:
        assert not use_prelu, "reference upsample blocks use ReLU"
        params["Conv_0"] = _conv(sd, f"{prefix}.spatil_conv", bias=False)
        bn(0, f"{prefix}.bn_up")
        params["Conv_1"] = _conv(sd, f"{prefix}.conv1", bias=False)
        bn(1, f"{prefix}.bn1")
        # flax ConvTranspose(use_bias=False): kernel only, no zeros bias
        params["ConvTranspose_0"] = {
            "kernel": _deconv_kernel(sd.take(f"{prefix}.conv2.weight"))}
        bn(2, f"{prefix}.bn2")
        params["Conv_2"] = _conv(sd, f"{prefix}.conv3", bias=False)
        bn(3, f"{prefix}.bn3")
        return params, stats

    params["Conv_0"] = _conv(sd, f"{prefix}.conv1", bias=False)
    bn(0, f"{prefix}.bn1")
    prelu(0, f"{prefix}.prelu1")
    if asymmetric:
        params["Conv_1"] = _conv(sd, f"{prefix}.conv2.0")
        bn(1, f"{prefix}.conv2.1")
        prelu(1, f"{prefix}.conv2.2")
        params["Conv_2"] = _conv(sd, f"{prefix}.conv2.3")
        bn(2, f"{prefix}.bn2")
        prelu(2, f"{prefix}.prelu2")
        params["Conv_3"] = _conv(sd, f"{prefix}.conv3", bias=False)
        bn(3, f"{prefix}.bn3")
        prelu(3, f"{prefix}.prelu3")
        prelu(4, f"{prefix}.prelu_out")
    else:
        params["Conv_1"] = _conv(sd, f"{prefix}.conv2", bias=False)
        bn(1, f"{prefix}.bn2")
        prelu(1, f"{prefix}.prelu2")
        params["Conv_2"] = _conv(sd, f"{prefix}.conv3", bias=False)
        bn(2, f"{prefix}.bn3")
        prelu(2, f"{prefix}.prelu3")
        prelu(3, f"{prefix}.prelu_out")
    return params, stats


_ENET_ENCODER_BLOCKS = (
    # (torch name, kwargs) in flax _ENetEncoder construction order
    [("bottleneck10", {"downsample": True})]
    + [(f"bottleneck1{i}", {}) for i in range(1, 5)]
    + [("bottleneck20", {"downsample": True})]
    + [
        (f"bottleneck{stage}{i}", kw)
        for stage in (2, 3)
        for i, kw in zip(
            range(1, 9),
            [{}, {}, {"asymmetric": True}, {}, {}, {},
             {"asymmetric": True}, {}],
        )
    ]
)


def _convert_enet_encoder(sd: _Consumer) -> tuple[dict, dict]:
    params: dict = {}
    stats: dict = {}
    init_p = {"Conv_0": _conv(sd, "initial.conv")}
    bn_p, bn_s = _bn(sd, "initial.bn")
    init_p["BatchNorm_0"] = bn_p
    w16 = _np(sd.take("initial.prelu.weight"))
    assert w16.shape == (16,), w16.shape
    init_p["ChannelPReLU_0"] = {"negative_slope": w16}
    params["InitialBlock_0"] = init_p
    stats["InitialBlock_0"] = {"BatchNorm_0": bn_s}
    for i, (name, kw) in enumerate(_ENET_ENCODER_BLOCKS):
        p, s = _enet_bottleneck(sd, name, **kw)
        params[f"BottleNeck_{i}"] = p
        stats[f"BottleNeck_{i}"] = s
    return params, stats


def convert_eflownet(state_dict: Mapping[str, object]) -> dict:
    """Reference EFlowNet (efficient_flow_net.py:147-246) -> flax variables
    for ``ocflow_tpu.models.EFlowNet``."""
    sd = _Consumer(state_dict)
    enc_p, enc_s = _convert_enet_encoder(sd)
    params: dict = {"_ENetEncoder_0": enc_p}
    stats: dict = {"_ENetEncoder_0": enc_s}
    dec = [("bottleneck40", {"upsample": True, "use_prelu": False}),
           ("bottleneck41", {"use_prelu": False}),
           ("bottleneck42", {"use_prelu": False}),
           ("bottleneck50", {"upsample": True, "use_prelu": False}),
           ("bottleneck51", {"use_prelu": False})]
    for i, (name, kw) in enumerate(dec):
        p, s = _enet_bottleneck(sd, name, **kw)
        params[f"BottleNeck_{i}"] = p
        stats[f"BottleNeck_{i}"] = s
    params["PredictFlow_0"] = {"Conv_0": _conv(sd, "predict_flow")}
    sd.finish()
    return {"params": params, "batch_stats": stats}


def convert_eflownet2(state_dict: Mapping[str, object]) -> dict:
    """Reference EFlowNet2 (efficient_flow_net.py:248-360) -> flax variables
    for ``ocflow_tpu.models.EFlowNet2``."""
    sd = _Consumer(state_dict)
    enc_p, enc_s = _convert_enet_encoder(sd)
    params: dict = {"_ENetEncoder_0": enc_p}
    stats: dict = {"_ENetEncoder_0": enc_s}
    params["PredictFlow_0"] = {"Conv_0": _conv(sd, "predict_flow3")}
    dec = [("bottleneck40", {"upsample": True, "use_prelu": False}),
           ("bottleneck41", {"use_prelu": False}),
           ("bottleneck42", {"use_prelu": False}),
           ("bottleneck50", {"upsample": True, "use_prelu": False}),
           ("bottleneck51", {"use_prelu": False})]
    for i, (name, kw) in enumerate(dec):
        p, s = _enet_bottleneck(sd, name, **kw)
        params[f"BottleNeck_{i}"] = p
        stats[f"BottleNeck_{i}"] = s
    params["PredictFlow_1"] = {"Conv_0": _conv(sd, "predict_flow4")}
    params["PredictFlow_2"] = {"Conv_0": _conv(sd, "predict_flow5")}
    sd.finish()
    return {"params": params, "batch_stats": stats}


def _convert_fpn(sd: _Consumer, prefix: str = "feature_pyramid_network"
                 ) -> tuple[dict, dict]:
    """Reference FeaturePyramidNet (feature_pyramid_net.py:47-93) -> the flax
    ``FeaturePyramidNet`` param/stat trees."""
    params: dict = {}
    stats: dict = {}
    for i in range(6):
        dc_p: dict = {}
        dc_s: dict = {}
        for j, (ci, bi) in enumerate(((0, 1), (3, 4))):
            bn_p, bn_s = _bn(sd, f"{prefix}.layer{i + 1}.double_conv.{bi}")
            dc_p[f"ConvBlock_{j}"] = {
                "Conv_0": _conv(sd, f"{prefix}.layer{i + 1}.double_conv.{ci}",
                                bias=False),
                "BatchNorm_0": bn_p,
            }
            dc_s[f"ConvBlock_{j}"] = {"BatchNorm_0": bn_s}
        params[f"DoubleConv_{i}"] = dc_p
        stats[f"DoubleConv_{i}"] = dc_s
    bn_p, bn_s = _bn(sd, f"{prefix}.pyr_top.1")
    params["ConvBlock_0"] = {
        "Conv_0": _conv(sd, f"{prefix}.pyr_top.0", bias=False),
        "BatchNorm_0": bn_p,
    }
    stats["ConvBlock_0"] = {"BatchNorm_0": bn_s}
    for i, lvl in enumerate((5, 4, 3, 2)):
        bn_p, bn_s = _bn(sd, f"{prefix}.upsample{lvl}.batchnorm")
        params[f"FPNUp_{i}"] = {
            "ConvTranspose_0": _deconv(sd, f"{prefix}.upsample{lvl}.deconv"),
            "BatchNorm_0": bn_p,
        }
        stats[f"FPNUp_{i}"] = {"BatchNorm_0": bn_s}
    return params, stats


def _convert_flow_estimator(sd: _Consumer, prefix: str, highest: bool) -> dict:
    """Reference OpticalFlowEstimator (flow_net.py:11-37)."""
    p = {f"ConvBlock_{j}": {"Conv_0": _conv(sd, f"{prefix}.conv{j + 1}")}
         for j in range(5)}
    p["Conv_0"] = _conv(sd, f"{prefix}.conv6")
    if not highest:
        p["ConvTranspose_0"] = _deconv(sd, f"{prefix}.upconv1")
        p["ConvTranspose_1"] = _deconv(sd, f"{prefix}.upconv2")
    return p


def _convert_context_net(sd: _Consumer, prefix: str = "context_network") -> dict:
    """Reference ContextNetwork (context_net.py:5-27)."""
    p = {f"ConvBlock_{j}": {"Conv_0": _conv(sd, f"{prefix}.conv{j + 1}")}
         for j in range(6)}
    p["Conv_0"] = _conv(sd, f"{prefix}.conv7")
    return p


def convert_flownet_fpn(state_dict: Mapping[str, object]) -> dict:
    """Reference FlowNet (flow_net.py:39-131, the FPN-trunk PWC variant) ->
    flax variables for ``ocflow_tpu.models.FlowNet``. The highest-res
    estimator's upconv1/upconv2 are dead weights in the reference (created
    but unused on the last level, flow_net.py:22-23,33)."""
    sd = _Consumer(state_dict)
    fp, fs = _convert_fpn(sd)
    params: dict = {"FeaturePyramidNet_0": fp}
    stats: dict = {"FeaturePyramidNet_0": fs}
    for i in range(5):
        params[f"OpticalFlowEstimator_{i}"] = _convert_flow_estimator(
            sd, f"opticalflow_estimators.{i}", highest=(i == 4))
    params["ContextNetwork_0"] = _convert_context_net(sd)
    sd.finish(allow_unused=("opticalflow_estimators.4.upconv",))
    return {"params": params, "batch_stats": stats}


def _convert_occ_estimator(sd: _Consumer, prefix: str, highest: bool) -> dict:
    """Reference OcclusionEstimator (flow_occ_net.py:39-68)."""
    names = ["conv1", "conv2", "conv3", "conv4", "feat_layer"]
    p = {f"ConvBlock_{j}": {"Conv_0": _conv(sd, f"{prefix}.{n}")}
         for j, n in enumerate(names)}
    p["Conv_0"] = _conv(sd, f"{prefix}.mask_layer")
    if not highest:
        p["ConvTranspose_0"] = _deconv(sd, f"{prefix}.upconv1")
        p["ConvTranspose_1"] = _deconv(sd, f"{prefix}.upconv2")
    return p


def convert_flow_occ_net_fpn(state_dict: Mapping[str, object]) -> dict:
    """Reference FlowOccNet (flow_occ_net.py:69-189, FPN joint flow+occ) ->
    flax variables for ``ocflow_tpu.models.FlowOccNet``. Same dead highest-
    res upconvs as convert_flownet_fpn, on both estimator towers."""
    sd = _Consumer(state_dict)
    fp, fs = _convert_fpn(sd)
    params: dict = {"FeaturePyramidNet_0": fp}
    stats: dict = {"FeaturePyramidNet_0": fs}
    for i in range(5):
        params[f"OcclusionEstimator_{i}"] = _convert_occ_estimator(
            sd, f"occlusion_estimators.{i}", highest=(i == 4))
        params[f"OpticalFlowEstimator_{i}"] = _convert_flow_estimator(
            sd, f"opticalflow_estimators.{i}", highest=(i == 4))
    params["ContextNetwork_0"] = _convert_context_net(sd)
    sd.finish(allow_unused=("opticalflow_estimators.4.upconv",
                            "occlusion_estimators.4.upconv"))
    return {"params": params, "batch_stats": stats}


def _proj_block3(sd: _Consumer, prefix: str, last_bn: bool = True) -> tuple[dict, dict]:
    """Three conv(bias=False)+BN(+LeakyReLU) stages of the proj-bottleneck
    Down/Upsample blocks (image_inpainting_net.py:5-57,
    simple_occlusion_net.py:6-59) -> ConvBlock_0..2. ``last_bn=False`` is the
    InpaintingNet up6 head whose bn3/lrelu3 are Identity (:42-43)."""
    params, stats = {}, {}
    for j in range(3):
        blk = {"Conv_0": _conv(sd, f"{prefix}.conv{j + 1}", bias=False)}
        if j < 2 or last_bn:
            bn_p, bn_s = _bn(sd, f"{prefix}.bn{j + 1}")
            blk["BatchNorm_0"] = bn_p
            stats[f"ConvBlock_{j}"] = {"BatchNorm_0": bn_s}
        params[f"ConvBlock_{j}"] = blk
    return params, stats


def convert_inpainting_net(state_dict: Mapping[str, object]) -> dict:
    """Reference InpaintingNet (image_inpainting_net.py:58-103) -> flax
    variables for ``ocflow_tpu.models.InpaintingNet``."""
    sd = _Consumer(state_dict)
    params: dict = {}
    stats: dict = {}
    for i in range(6):
        p, s = _proj_block3(sd, f"down{i + 1}")
        params[f"_Down_{i}"], stats[f"_Down_{i}"] = p, s
    for i in range(6):
        p, s = _proj_block3(sd, f"up{i + 1}", last_bn=i < 5)
        params[f"_Up_{i}"], stats[f"_Up_{i}"] = p, s
    sd.finish()
    return {"params": params, "batch_stats": stats}


def _occ_stack(sd: _Consumer, name: str) -> dict:
    """predict_occ(...) Sequential (simple_occlusion_net.py:130-136):
    conv(·,32) -> conv(32,16) -> conv(16,1) -> PredictOccStack params."""
    return {
        "ConvBlock_0": {"Conv_0": _conv(sd, f"{name}.0.0")},
        "ConvBlock_1": {"Conv_0": _conv(sd, f"{name}.1.0")},
        "Conv_0": _conv(sd, f"{name}.2.0"),
    }


def convert_simple_occlusion_net(state_dict: Mapping[str, object]) -> dict:
    """Reference SimpleOcclusionNet (simple_occlusion_net.py:60-128) -> flax
    variables for ``ocflow_tpu.models.SimpleOcclusionNet``. This is also the
    splice path for the reference's trained two-stage checkpoints
    (model.py:948-954 loads ``occ_pred`` from a Lightning checkpoint)."""
    sd = _Consumer(state_dict)
    params: dict = {}
    stats: dict = {}
    for i in range(5):
        p, s = _proj_block3(sd, f"down{i + 1}")
        params[f"ProjDown_{i}"], stats[f"ProjDown_{i}"] = p, s
    for i in range(5):
        p, s = _proj_block3(sd, f"up{i + 1}")
        params[f"ProjUp_{i}"], stats[f"ProjUp_{i}"] = p, s
    # creation order: PredictOccStack_0..5 ↔ predict_occ5..1,0 (decoder order)
    for i, k in enumerate((5, 4, 3, 2, 1, 0)):
        params[f"PredictOccStack_{i}"] = _occ_stack(sd, f"predict_occ{k}")
    sd.finish()
    return {"params": params, "batch_stats": stats}


def convert_occlusion_net_s(state_dict: Mapping[str, object], use_bn: bool = True) -> dict:
    """Reference OcclusionNetS (occlusion_net_s.py:10-89) -> flax variables
    for ``ocflow_tpu.models.OcclusionNetS``."""
    sd = _Consumer(state_dict)
    params: dict = {}
    stats: dict = {}

    enc_p, enc_s = {}, {}
    convs = ["conv1", "conv2", "conv3", "conv3_1", "conv4", "conv4_1",
             "conv5", "conv5_1", "conv6", "conv6_1"]
    for i, n in enumerate(convs):
        blk = {"Conv_0": _conv(sd, f"{n}.0", bias=not use_bn)}
        if use_bn:
            bn_p, bn_s = _bn(sd, f"{n}.1")
            blk["BatchNorm_0"] = bn_p
            enc_s[f"ConvBlock_{i}"] = {"BatchNorm_0": bn_s}
        enc_p[f"ConvBlock_{i}"] = blk
    params["_FNetSEncoder_0"] = enc_p
    if use_bn:
        stats["_FNetSEncoder_0"] = enc_s

    # creation order per level: PredictOcc_i, Deconv(occ up, bias=False),
    # Deconv(features) — occlusion_net_s.py:69-89
    ups = ["upsampled_occ6_to_5", "upsampled_occ5_to_4",
           "upsampled_occ4_to_3", "upsampled_occ3_to_2"]
    decs = ["deconv5", "deconv4", "deconv3", "deconv2"]
    for i, lvl in enumerate((6, 5, 4, 3, 2)):
        params[f"PredictOcc_{i}"] = {"Conv_0": _conv(sd, f"predict_occ{lvl}.0")}
        if lvl > 2:
            params[f"Deconv_{2 * i}"] = {
                "ConvTranspose_0": _deconv(sd, ups[i], bias=False)
            }
            params[f"Deconv_{2 * i + 1}"] = {
                "ConvTranspose_0": _deconv(sd, f"{decs[i]}.0")
            }

    sd.finish()
    out = {"params": params}
    if use_bn:
        out["batch_stats"] = stats
    return out


def convert_simple_flow_occ_net(state_dict: Mapping[str, object]) -> dict:
    """Reference SimpleFlowOccNet (simple_flow_occ_net.py:60-137) -> flax
    variables for ``ocflow_tpu.models.SimpleFlowOccNet``."""
    sd = _Consumer(state_dict)
    params: dict = {}
    stats: dict = {}
    for i in range(5):
        p, st = _proj_block3(sd, f"down{i + 1}")
        params[f"ProjDown_{i}"], stats[f"ProjDown_{i}"] = p, st
    for i in range(4):
        p, st = _proj_block3(sd, f"up{i + 1}")
        params[f"ProjUp_{i}"], stats[f"ProjUp_{i}"] = p, st
    # creation order per decoder level: PredictFlowStack_i, PredictOccStack_i
    # ↔ predict_flow{5-i}/predict_occ{5-i} (simple_flow_occ_net.py:114-136)
    for i, lvl in enumerate((5, 4, 3, 2, 1)):
        params[f"PredictFlowStack_{i}"] = {
            "ConvBlock_0": {"Conv_0": _conv(sd, f"predict_flow{lvl}.0.0")},
            "ConvBlock_1": {"Conv_0": _conv(sd, f"predict_flow{lvl}.1.0")},
            "Conv_0": _conv(sd, f"predict_flow{lvl}.2.0"),
        }
        params[f"PredictOccStack_{i}"] = _occ_stack(sd, f"predict_occ{lvl}")
    sd.finish()
    return {"params": params, "batch_stats": stats}


def convert_flow_occ_net_s(state_dict: Mapping[str, object], use_bn: bool = True) -> dict:
    """Reference FlowOccNetS (flow_occ_net_s.py:10-117) -> flax variables
    for ``ocflow_tpu.models.FlowOccNetS``."""
    sd = _Consumer(state_dict)
    params: dict = {}
    stats: dict = {}

    enc_p, enc_s = {}, {}
    convs = ["conv1", "conv2", "conv3", "conv3_1", "conv4", "conv4_1",
             "conv5", "conv5_1", "conv6", "conv6_1"]
    for i, n in enumerate(convs):
        blk = {"Conv_0": _conv(sd, f"{n}.0", bias=not use_bn)}
        if use_bn:
            bn_p, bn_s = _bn(sd, f"{n}.1")
            blk["BatchNorm_0"] = bn_p
            enc_s[f"ConvBlock_{i}"] = {"BatchNorm_0": bn_s}
        enc_p[f"ConvBlock_{i}"] = blk
    params["_FNetSEncoder_0"] = enc_p
    if use_bn:
        stats["_FNetSEncoder_0"] = enc_s

    # per level (flow_occ_net_s.py:86-116): PredictFlow_i, PredictOcc_i,
    # Deconv(flow up, bias=False), Deconv(occ up, bias=False), Deconv(feat)
    decs = ["deconv5", "deconv4", "deconv3", "deconv2"]
    for i, lvl in enumerate((6, 5, 4, 3, 2)):
        params[f"PredictFlow_{i}"] = {"Conv_0": _conv(sd, f"predict_flow{lvl}")}
        params[f"PredictOcc_{i}"] = {"Conv_0": _conv(sd, f"predict_occ{lvl}.0")}
        if lvl > 2:
            nxt = lvl - 1
            params[f"Deconv_{3 * i}"] = {"ConvTranspose_0": _deconv(
                sd, f"upsampled_flow{lvl}_to_{nxt}", bias=False)}
            params[f"Deconv_{3 * i + 1}"] = {"ConvTranspose_0": _deconv(
                sd, f"upsampled_occ{lvl}_to_{nxt}", bias=False)}
            params[f"Deconv_{3 * i + 2}"] = {
                "ConvTranspose_0": _deconv(sd, f"{decs[i]}.0")}

    sd.finish()
    out = {"params": params}
    if use_bn:
        out["batch_stats"] = stats
    return out


def convert_flow_occ_net_cv(state_dict: Mapping[str, object]) -> dict:
    """Reference FlowOccNetCV (cost_volume_flow_occ_net.py:26-271) -> flax
    variables for ``ocflow_tpu.models.FlowOccNetCV``. The reference file is
    import-broken (missing cost_volume_net module); goldens run it with a
    stub CostVolumeLayer pinned to our documented repair semantics
    (per-pixel channel MEAN of f1 * shifted(f2), dy-major channels)."""
    sd = _Consumer(state_dict)
    params: dict = {}

    enc_names = []
    for lvl in range(1, 6):
        enc_names += [f"conv{lvl}a", f"conv{lvl}aa", f"conv{lvl}b"]
    enc_names += ["conv6aa", "conv6a", "conv6b"]
    params["SiameseEncoder_0"] = {
        f"ConvBlock_{i}": {"Conv_0": _conv(sd, f"{n}.0")}
        for i, n in enumerate(enc_names)
    }

    # decoder creation order: _DenseFlowOccDecoder_i then (lvl>1) the
    # upflow/upocc/upfeat deconv triplet (flow_occ_nets.py:188-206)
    for i, lvl in enumerate((6, 5, 4, 3, 2)):
        dec = {
            f"ConvBlock_{j}": {"Conv_0": _conv(sd, f"conv{lvl}_{j}.0")}
            for j in range(5)
        }
        dec["PredictFlow_0"] = {"Conv_0": _conv(sd, f"predict_flow{lvl}")}
        dec["PredictOcc_0"] = {"Conv_0": _conv(sd, f"predict_occ{lvl}.0")}
        params[f"_DenseFlowOccDecoder_{i}"] = dec
        if lvl > 2:
            params[f"Deconv_{3 * i}"] = {
                "ConvTranspose_0": _deconv(sd, f"upflow{lvl}")}
            params[f"Deconv_{3 * i + 1}"] = {
                "ConvTranspose_0": _deconv(sd, f"upocc{lvl}")}
            params[f"Deconv_{3 * i + 2}"] = {
                "ConvTranspose_0": _deconv(sd, f"upfeat{lvl}")}

    ctx = {
        f"ConvBlock_{j}": {"Conv_0": _conv(sd, f"dc_conv{j + 1}.0")}
        for j in range(6)
    }
    ctx["Conv_0"] = _conv(sd, "dc_conv7")
    params["ContextNetwork_0"] = ctx

    sd.finish()
    return {"params": params}


def convert_flow_occ_net_cv2(state_dict: Mapping[str, object]) -> dict:
    """Reference FlowOccNetCV2 (cost_volume_flow_occ_net.py:273-553) -> flax
    variables for ``ocflow_tpu.models.FlowOccNetCV2``.

    The reference net is DOUBLY broken: the missing CostVolumeLayer import
    plus a forward that references never-defined ``conv{L}_j`` towers while
    its __init__ builds separate ``fe{L}_j``/``oe{L}_j`` flow/occ towers
    (:308-318 vs :474-478). Goldens run a minimally-repaired torch mirror
    that wires the declared separate towers (the repo's documented repair,
    tests/test_models_semantics.py::test_flowoccnetcv2_towers_are_separate);
    the converter maps those tower weights."""
    sd = _Consumer(state_dict)
    params: dict = {}

    enc_names = []
    for lvl in range(1, 6):
        enc_names += [f"conv{lvl}a", f"conv{lvl}aa", f"conv{lvl}b"]
    enc_names += ["conv6aa", "conv6a", "conv6b"]
    params["SiameseEncoder_0"] = {
        f"ConvBlock_{i}": {"Conv_0": _conv(sd, f"{n}.0")}
        for i, n in enumerate(enc_names)
    }

    # decoder creation order: flow tower ConvBlock_0..4 + PredictFlow_0,
    # occ tower ConvBlock_5..9 + PredictOcc_0 (_SeparateFlowOccDecoder),
    # then (lvl>1) the upflow/upocc/upfeat deconv triplet
    for i, lvl in enumerate((6, 5, 4, 3, 2)):
        dec = {
            f"ConvBlock_{j}": {"Conv_0": _conv(sd, f"fe{lvl}_{j}.0")}
            for j in range(5)
        }
        dec["PredictFlow_0"] = {"Conv_0": _conv(sd, f"predict_flow{lvl}")}
        for j in range(5):
            dec[f"ConvBlock_{5 + j}"] = {"Conv_0": _conv(sd, f"oe{lvl}_{j}.0")}
        dec["PredictOcc_0"] = {"Conv_0": _conv(sd, f"predict_occ{lvl}.0")}
        params[f"_SeparateFlowOccDecoder_{i}"] = dec
        if lvl > 2:
            params[f"Deconv_{3 * i}"] = {
                "ConvTranspose_0": _deconv(sd, f"upflow{lvl}")}
            params[f"Deconv_{3 * i + 1}"] = {
                "ConvTranspose_0": _deconv(sd, f"upocc{lvl}")}
            params[f"Deconv_{3 * i + 2}"] = {
                "ConvTranspose_0": _deconv(sd, f"upfeat{lvl}")}

    ctx = {
        f"ConvBlock_{j}": {"Conv_0": _conv(sd, f"dc_conv{j + 1}.0")}
        for j in range(6)
    }
    ctx["Conv_0"] = _conv(sd, "dc_conv7")
    params["ContextNetwork_0"] = ctx

    sd.finish()
    return {"params": params}


def _fnetc_trunk(sd: _Consumer, use_bn: bool) -> tuple[dict, dict]:
    """The shared FlowNetC-style trunk of FlowOccNetC / OcclusionNetC
    (flow_occ_net_c.py:21-36, occlusion_net_c.py:17-33): siamese conv1-3,
    conv_redir, merged conv3_1..conv6_1 -> ConvBlock_0..10."""
    params, stats = {}, {}
    names = ["conv1", "conv2", "conv3", "conv_redir", "conv3_1",
             "conv4", "conv4_1", "conv5", "conv5_1", "conv6", "conv6_1"]
    for i, n in enumerate(names):
        blk = {"Conv_0": _conv(sd, f"{n}.0", bias=not use_bn)}
        if use_bn:
            bn_p, bn_s = _bn(sd, f"{n}.1")
            blk["BatchNorm_0"] = bn_p
            stats[f"ConvBlock_{i}"] = {"BatchNorm_0": bn_s}
        params[f"ConvBlock_{i}"] = blk
    return params, stats


def convert_flow_occ_net_c(state_dict: Mapping[str, object], use_bn: bool = True) -> dict:
    """Reference FlowOccNetC (flow_occ_net_c.py:11-146, import-broken; see
    the CostVolumeLayer stub note on convert_flow_occ_net_cv) -> flax
    variables for ``ocflow_tpu.models.FlowOccNetC``."""
    sd = _Consumer(state_dict)
    params, stats = _fnetc_trunk(sd, use_bn)
    decs = ["deconv5", "deconv4", "deconv3", "deconv2"]
    for i, lvl in enumerate((6, 5, 4, 3, 2)):
        params[f"PredictFlow_{i}"] = {"Conv_0": _conv(sd, f"predict_flow{lvl}")}
        params[f"PredictOcc_{i}"] = {"Conv_0": _conv(sd, f"predict_occ{lvl}.0")}
        if lvl > 2:
            nxt = lvl - 1
            # the *_up deconvs are bias=True in this variant (:58-61),
            # unlike flow_occ_net_s
            params[f"Deconv_{3 * i}"] = {"ConvTranspose_0": _deconv(
                sd, f"upsampled_flow{lvl}_to_{nxt}")}
            params[f"Deconv_{3 * i + 1}"] = {"ConvTranspose_0": _deconv(
                sd, f"upsampled_occ{lvl}_to_{nxt}")}
            params[f"Deconv_{3 * i + 2}"] = {
                "ConvTranspose_0": _deconv(sd, f"{decs[i]}.0")}
    sd.finish()
    out = {"params": params}
    if use_bn:
        out["batch_stats"] = stats
    return out


def convert_occlusion_net_c(state_dict: Mapping[str, object], use_bn: bool = True) -> dict:
    """Reference OcclusionNetC (occlusion_net_c.py:10-118, import-broken;
    stub note as above) -> flax ``ocflow_tpu.models.OcclusionNetC``."""
    sd = _Consumer(state_dict)
    params, stats = _fnetc_trunk(sd, use_bn)
    decs = ["deconv5", "deconv4", "deconv3", "deconv2"]
    for i, lvl in enumerate((6, 5, 4, 3, 2)):
        params[f"PredictOcc_{i}"] = {"Conv_0": _conv(sd, f"predict_occ{lvl}.0")}
        if lvl > 2:
            nxt = lvl - 1
            params[f"Deconv_{2 * i}"] = {"ConvTranspose_0": _deconv(
                sd, f"upsampled_occ{lvl}_to_{nxt}")}  # bias=True here
            params[f"Deconv_{2 * i + 1}"] = {
                "ConvTranspose_0": _deconv(sd, f"{decs[i]}.0")}
    sd.finish()
    out = {"params": params}
    if use_bn:
        out["batch_stats"] = stats
    return out


def _sn_conv(sd: _Consumer, name: str, bias: bool = True) -> tuple[dict, dict]:
    """A torch ``nn.utils.spectral_norm``-wrapped Conv2d -> (flax Conv params,
    flax SpectralNorm batch_stats). The torch ``weight_u`` (size O) maps onto
    flax's ``u`` (1, O): both reshape the kernel to a (·, O)-column matrix
    whose row ordering differs only by a permutation, which leaves every
    power-iteration quantity (v-norms, u-updates, sigma) identical — so one
    torch train-mode forward == one flax ``update_stats=True`` forward,
    exactly (proven in tests/test_parity_networks.py)."""
    kernel = _conv_kernel(sd.take(f"{name}.weight_orig"))
    u = _np(sd.take(f"{name}.weight_u")).reshape(1, -1).astype(np.float32)
    # weight_v is torch's cached right vector; both frameworks recompute v
    # from u before use in train mode, so it carries no information here.
    sd.take(f"{name}.weight_v")
    p = {"kernel": kernel}
    if bias:
        p["bias"] = _np(sd.take(f"{name}.bias"))
    st = {"Conv_0/kernel/u": u, "Conv_0/kernel/sigma": np.float32(1.0)}
    return {"Conv_0": p}, {"SpectralNorm_0": st}


def _gated_tower(sd: _Consumer, prefix: str, bias: bool = False) -> dict:
    """Conv2dWithProj (gated_conv_inpainting_net.py:20-36) -> _ProjConv
    params. ``bias=True`` only inside the gated deconvs (:118)."""
    return {
        f"_Conv_{j}": {"Conv_0": _conv(sd, f"{prefix}.conv{j + 1}", bias=bias)}
        for j in range(3)
    }


def _gated_block(
    sd: _Consumer, prefix: str, projected: bool, proj_bias: bool = False
) -> tuple[dict, dict]:
    """GatedProjConv2dWithActivation (:38-74) / GatedConv2dWithActivation
    (:76-109) -> GatedConv params+stats. Note the torch BN attribute is
    ``batch_norm`` (proj) vs ``batch_norm2d`` (plain)."""
    if projected:
        p = {
            "_ProjConv_0": _gated_tower(sd, f"{prefix}.conv2d", proj_bias),
            "_ProjConv_1": _gated_tower(sd, f"{prefix}.mask_conv2d", proj_bias),
        }
        bn_p, bn_s = _bn(sd, f"{prefix}.batch_norm")
    else:
        p = {
            "_Conv_0": {"Conv_0": _conv(sd, f"{prefix}.conv2d")},
            "_Conv_1": {"Conv_0": _conv(sd, f"{prefix}.mask_conv2d")},
        }
        bn_p, bn_s = _bn(sd, f"{prefix}.batch_norm2d")
    p["BatchNorm_0"] = bn_p
    return p, {"BatchNorm_0": bn_s}


def _gated_trunk(
    sd: _Consumer, prefix: str, n: int, deconv_at: tuple[int, ...], projected: bool
) -> tuple[dict, dict]:
    """An nn.Sequential of gated (de)convs -> trunk params/stats. Sequential
    index i is a GatedDeConv iff ``i in deconv_at`` (its gated conv lives at
    ``{prefix}.{i}.conv2d`` — the deconv wraps a gated conv, :111-144)."""
    params, stats = {}, {}
    gc = gd = 0
    for i in range(n):
        if i in deconv_at:
            # the deconv's inner gated conv gets bias=True even when
            # projected (GatedProjDeConv2dWithActivation default, :118)
            p, s = _gated_block(sd, f"{prefix}.{i}.conv2d", projected,
                                proj_bias=True)
            params[f"GatedDeConv_{gd}"] = {"GatedConv_0": p}
            stats[f"GatedDeConv_{gd}"] = {"GatedConv_0": s}
            gd += 1
        else:
            p, s = _gated_block(sd, f"{prefix}.{i}", projected)
            params[f"GatedConv_{gc}"] = p
            stats[f"GatedConv_{gc}"] = s
            gc += 1
    return params, stats


def _self_attn(sd: _Consumer, prefix: str) -> dict:
    """Self_Attn (:284-317) -> SelfAttention params (query/key/value 1x1
    convs + gamma)."""
    return {
        "Conv_0": _conv(sd, f"{prefix}.query_conv"),
        "Conv_1": _conv(sd, f"{prefix}.key_conv"),
        "Conv_2": _conv(sd, f"{prefix}.value_conv"),
        "gamma": _np(sd.take(f"{prefix}.gamma")),
    }


def convert_inpaint_sanet(
    state_dict: Mapping[str, object], projected: bool = True
) -> dict:
    """Reference InpaintSANet (:319-407, projected) / InpaintSANetOrg
    (:430-514, plain) -> flax variables for ``ocflow_tpu.models.InpaintSANet``
    / ``InpaintSANetOrg``. This is the splice path for the reference's
    two-stage pipelines, which load a *trained torch* generator
    (model.py:1133-1135 ``InpaintingStageModel.load_from_checkpoint``)."""
    sd = _Consumer(state_dict)
    params: dict = {}
    stats: dict = {}
    for key, tp, n, dec in (
        ("_GeneratorTrunk_0", "coarse_net", 17, (12, 14)),
        ("_RefineTrunk_0", "refine_conv_net", 11, ()),
        ("_RefineUpsample_0", "refine_upsample_net", 7, (2, 4)),
    ):
        p, s = _gated_trunk(sd, tp, n, dec, projected)
        params[key], stats[key] = p, s
    params["SelfAttention_0"] = _self_attn(sd, "refine_attn")
    sd.finish()
    return {"params": params, "batch_stats": stats}


def convert_inpaint_discriminator(
    state_dict: Mapping[str, object], projected: bool = True
) -> dict:
    """Reference InpaintSADiscriminator (:409-428, projected) /
    InpaintSADiscriminatorOrg (:516-537, plain) -> flax variables for
    ``ocflow_tpu.models.InpaintSADiscriminator(Org)``. Spectral-norm ``u``
    vectors transfer exactly (see ``_sn_conv``)."""
    sd = _Consumer(state_dict)
    params: dict = {}
    stats: dict = {}
    for i in range(5):
        prefix = f"discriminator_net.{i}.conv2d"
        if projected:
            tp, ts = {}, {}
            for j in range(3):
                cp, cs = _sn_conv(sd, f"{prefix}.conv{j + 1}")
                tp[f"_Conv_{j}"], ts[f"_Conv_{j}"] = cp, cs
            params[f"_ProjConv_{i}"], stats[f"_ProjConv_{i}"] = tp, ts
        else:
            cp, cs = _sn_conv(sd, prefix)
            params[f"_Conv_{i}"], stats[f"_Conv_{i}"] = cp, cs
    sd.finish()
    return {"params": params, "batch_stats": stats}


def variables_to_npz(variables: dict, out_path: str) -> None:
    """Flatten a flax variables tree to '/'-joined keys and save as npz."""
    flat: dict[str, np.ndarray] = {}

    def rec(node, prefix):
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, Mapping):
                rec(v, key)
            else:
                flat[key] = np.asarray(v)

    rec(variables, "")
    np.savez(out_path, **flat)


def npz_to_variables(path: str) -> dict:
    """Inverse of :func:`variables_to_npz`."""
    loaded = np.load(path)
    tree: dict = {}
    for key in loaded.files:
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = loaded[key]
    return tree


CONVERTERS = {
    "flownetcv": convert_flownetcv,
    "pwc": convert_flownetcv,
    "pwcnet": convert_pwcnet,
    "flownets": convert_flownets,
    "flownetc": convert_flownetc,
    "simple": convert_simpleflownet,
    "eflownet": convert_eflownet,
    "eflownet2": convert_eflownet2,
    "flownet_fpn": convert_flownet_fpn,
    "flow_occ_fpn": convert_flow_occ_net_fpn,
    "flow_occ_cv": convert_flow_occ_net_cv,
    "flow_occ_cv2": convert_flow_occ_net_cv2,
    "flow_occ_s": convert_flow_occ_net_s,
    "flow_occ_c": convert_flow_occ_net_c,
    "simple_flow_occ": convert_simple_flow_occ_net,
    "simple_occ": convert_simple_occlusion_net,
    "occ_s": convert_occlusion_net_s,
    "occ_c": convert_occlusion_net_c,
    "inpainting": convert_inpainting_net,
    "sanet": convert_inpaint_sanet,
    "sanet_org": lambda sd: convert_inpaint_sanet(sd, projected=False),
    "sa_discriminator": convert_inpaint_discriminator,
    "sa_discriminator_org": lambda sd: convert_inpaint_discriminator(sd, projected=False),
}
"""Network name -> converter: the names of the JAX package's
``convert_checkpoint`` and of its weight tool's classifier, plus
``flow_occ_c`` and ``occ_c`` (FlowOccNetC, OcclusionNetC)."""

# the sub-module of a combined Lightning checkpoint each network is read from
ROLE_FOR = {
    "inpainting": "generator.", "sanet": "generator.", "sanet_org": "generator.",
    "sa_discriminator": "discriminator.", "sa_discriminator_org": "discriminator.",
    "simple_occ": "occ_pred.", "occ_s": "occ_pred.", "occ_c": "occ_pred.",
}


def select_role(state_dict: Mapping[str, object], network: str) -> dict:
    """The sub-``state_dict`` of ``network`` in a (possibly Lightning,
    possibly combined) ``state_dict``: the ``model.`` / ``flow_pred.``
    wrappers stripped; where ``generator.``, ``discriminator.`` or
    ``occ_pred.`` keys are present, only the role ``network`` implies (or
    the only role present)."""
    sd = {
        k.split(".", 1)[1] if k.startswith(("model.", "flow_pred.")) else k: v
        for k, v in state_dict.items()
    }
    present = {p for p in ("generator.", "discriminator.", "occ_pred.")
               if any(k.startswith(p) for k in sd)}
    if present:
        want = ROLE_FOR.get(network)
        if want is None:
            if len(present) > 1:
                raise ValueError(
                    f"checkpoint holds multiple sub-modules {sorted(present)}; "
                    f"network '{network}' does not select one")
            want = next(iter(present))
        sd = {k[len(want):]: v for k, v in sd.items() if k.startswith(want)}
        if not sd:
            raise ValueError(
                f"no '{want}*' keys in checkpoint (has {sorted(present)})")
    return sd


def load_state_dict(path: str) -> dict:
    """A torch checkpoint file as a ``state_dict``: a Lightning
    checkpoint's ``state_dict`` entry, or the file's dict. Read with
    ``weights_only=False``: Lightning pickles its hyperparameters."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if not isinstance(sd, dict):
        raise ValueError(f"{path}: not a state_dict ({type(sd).__name__})")
    return sd


def convert_checkpoint(path: str, network: str, out_path: str) -> None:
    """Convert a torch checkpoint file to a flax-layout ``.npz``
    (:func:`variables_to_npz`). ``network``: a key of :data:`CONVERTERS`.
    Lightning checkpoints are unwrapped (``state_dict`` entry, ``model.`` /
    ``flow_pred.`` prefixes stripped, the role ``network`` implies kept:
    :func:`select_role`)."""
    sd = select_role(load_state_dict(path), network)
    variables_to_npz(CONVERTERS[network](sd), out_path)
