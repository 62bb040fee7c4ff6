"""The port's models: FlowNetCV / PWCNet (eager), their fused serving path
and weight bridge; the FlowNetC family (FlowNetC, OcclusionNetC,
FlowOccNetC) and the FlowNetS family (FlowNetS, OcclusionNetS,
FlowOccNetS); SimpleFlowNet, SimpleOcclusionNet and SimpleFlowOccNet; the
FPN FlowNet and FlowOccNet; the PWC-style flow+occlusion nets FlowOccNetCV
(``pwoc``) and FlowOccNetCV2 (``pwoc2``); the ENet flow nets EFlowNet and
EFlowNet2; the inpainters InpaintingNet, InpaintSANet and InpaintSANetOrg,
the spectral-norm discriminators InpaintSADiscriminator and
InpaintSADiscriminatorOrg, and the pipeline OCFlowNet; their weight
bridges from flax; the registry ``build`` with
``load_model`` and ``predict``, as the CLIs serve a model. Serve the nets
with BatchNorm in eval mode."""

from ocflow_torch.models.convert import (discriminator_from_flax, eflownet_from_flax,
                                         flownet_from_flax,
                                         flownetc_from_flax, flownetcv_from_flax,
                                         flownets_from_flax, flowoccnet_from_flax,
                                         flowoccnetc_from_flax, flowoccnetcv2_from_flax,
                                         flowoccnetcv_from_flax, flowoccnets_from_flax,
                                         inpaintingnet_from_flax, inpaintsanet_from_flax,
                                         inpaintsanetorg_from_flax, occnetc_from_flax,
                                         occnets_from_flax, ocflownet_from_flax,
                                         q8_scales_from_numpy, simpleflownet_from_flax,
                                         simpleflowoccnet_from_flax, simpleoccnet_from_flax)
from ocflow_torch.models.efficient_flow_net import EFlowNet, EFlowNet2
from ocflow_torch.models.flow_net import FlowNet
from ocflow_torch.models.flow_net_s import FlowNetC, FlowNetCFamily, FlowNetS, FlowNetSFamily
from ocflow_torch.models.flow_occ_nets import (FlowOccNet, FlowOccNetC, FlowOccNetCV,
                                               FlowOccNetCV2, FlowOccNetS, SimpleFlowOccNet)
from ocflow_torch.models.gated_conv import (InpaintSADiscriminator, InpaintSADiscriminatorOrg,
                                            InpaintSANet, InpaintSANetOrg)
from ocflow_torch.models.inpainting_net import InpaintingNet
from ocflow_torch.models.occlusion_nets import OcclusionNetC, OcclusionNetS, SimpleOcclusionNet
from ocflow_torch.models.ocflownet import OCFlowNet
from ocflow_torch.models.pwc_fast import calibrate_q8, fast_apply, fast_apply_pair, prepare
from ocflow_torch.models.pwc_net import FlowNetCV, PWCNet
from ocflow_torch.models.registry import available, build, load_model, predict
from ocflow_torch.models.simple_flow_net import SimpleFlowNet

__all__ = ["EFlowNet", "EFlowNet2", "FlowNet", "FlowNetC", "FlowNetCFamily", "FlowNetCV",
           "FlowNetS", "FlowNetSFamily", "FlowOccNet", "FlowOccNetC", "FlowOccNetCV",
           "FlowOccNetCV2", "FlowOccNetS", "InpaintSADiscriminator", "InpaintSADiscriminatorOrg",
           "InpaintSANet", "InpaintSANetOrg", "InpaintingNet", "OCFlowNet", "OcclusionNetC",
           "OcclusionNetS", "PWCNet",
           "SimpleFlowNet", "SimpleFlowOccNet", "SimpleOcclusionNet", "available", "build",
           "calibrate_q8", "discriminator_from_flax", "eflownet_from_flax", "fast_apply", "fast_apply_pair",
           "flownet_from_flax", "flownetc_from_flax", "flownetcv_from_flax",
           "flownets_from_flax", "flowoccnet_from_flax", "flowoccnetc_from_flax",
           "flowoccnetcv2_from_flax", "flowoccnetcv_from_flax", "flowoccnets_from_flax",
           "inpaintingnet_from_flax", "inpaintsanet_from_flax", "inpaintsanetorg_from_flax",
           "load_model", "occnetc_from_flax", "occnets_from_flax",
           "ocflownet_from_flax", "predict", "prepare",
           "q8_scales_from_numpy", "simpleflownet_from_flax", "simpleflowoccnet_from_flax",
           "simpleoccnet_from_flax"]
