"""String-key model registry (port of ``ocflow_tpu/models/registry.py``):
``build(family, key, **kwargs)`` returns a port module; the port has every
key of the JAX registry. Unknown families and keys raise, listing what is
available.
``load_model`` builds one for serving (seeded or from a checkpoint, eval
mode) and ``predict`` runs its eager fp32 forward, as both CLIs serve it.
"""

from __future__ import annotations

import torch

from ocflow_torch import full_fp32_convs
from ocflow_torch.models.efficient_flow_net import EFlowNet, EFlowNet2
from ocflow_torch.models.flow_net import FlowNet
from ocflow_torch.models.flow_net_s import FlowNetC, FlowNetS
from ocflow_torch.models.flow_occ_nets import (FlowOccNet, FlowOccNetC, FlowOccNetCV,
                                               FlowOccNetCV2, FlowOccNetS, SimpleFlowOccNet)
from ocflow_torch.models.gated_conv import (InpaintSADiscriminator, InpaintSADiscriminatorOrg,
                                            InpaintSANet, InpaintSANetOrg)
from ocflow_torch.models.inpainting_net import InpaintingNet
from ocflow_torch.models.ocflownet import OCFlowNet
from ocflow_torch.models.occlusion_nets import OcclusionNetC, OcclusionNetS, SimpleOcclusionNet
from ocflow_torch.models.pwc_net import FlowNetCV, PWCNet
from ocflow_torch.models.simple_flow_net import SimpleFlowNet

# the JAX registry's families, key for key
_REGISTRY = {
    "flow": {"simple": SimpleFlowNet, "pwc": FlowNetCV, "pwcnet": PWCNet,
             "flownets": FlowNetS, "flownetc": FlowNetC, "flownet": FlowNet,
             "eflownet": EFlowNet, "eflownet2": EFlowNet2},
    "occ": {"simple": SimpleOcclusionNet, "occnets": OcclusionNetS, "occnetc": OcclusionNetC},
    "flow_occ": {"simple": SimpleFlowOccNet, "flowoccnets": FlowOccNetS,
                 "flowoccnetc": FlowOccNetC, "pwoc": FlowOccNetCV, "pwoc2": FlowOccNetCV2,
                 "flowoccnet": FlowOccNet},
    "inpainting": {"simple": InpaintingNet, "gated": InpaintSANet, "gated_org": InpaintSANetOrg},
    "discriminator": {"gated": InpaintSADiscriminator, "gated_org": InpaintSADiscriminatorOrg},
    "pipeline": {"ocflownet": OCFlowNet},
}


def available() -> dict[str, list[str]]:
    """``{family: [keys]}`` of every model the port builds."""
    return {f: sorted(keys) for f, keys in _REGISTRY.items()}


def build(family: str, key: str, **kwargs):
    """The module registered under ``family``/``key``, built with
    ``kwargs`` (e.g. ``generator=`` for a seeded init, ``device=``, and
    ``remat=`` for the gated-conv generators). Unknown names raise
    ``ValueError``."""
    if family not in _REGISTRY:
        raise ValueError(f"unknown model family {family!r}; the port has {available()}")
    if key not in _REGISTRY[family]:
        raise ValueError(f"unknown model {key!r} in family {family!r}; the port "
                         f"has {available()}")
    return _REGISTRY[family][key](**kwargs)


def load_model(family: str, key: str, checkpoint: str = "", device=None) -> torch.nn.Module:
    """The network ``build(family, key)`` on ``device`` in eval mode:
    seeded from 0, or with the ``params`` of a port checkpoint (of a GAN
    run's ``(generator, discriminator)`` checkpoint, the generator's).
    Unknown keys raise (:func:`build`)."""
    # imported here: utils.checkpoint imports the train package, which
    # imports the models
    from ocflow_torch.utils.checkpoint import load_pytree

    model = build(family, key, generator=torch.Generator().manual_seed(0))
    if checkpoint:
        tree = load_pytree(checkpoint)
        if isinstance(tree, (list, tuple)):
            tree = tree[0]
        model.load_state_dict(tree["params"])
    return model.to(device).eval()


def predict(model: torch.nn.Module, x: torch.Tensor) -> tuple:
    """The eager fp32 forward of ``[B, H, W, 6]`` frames, full fp32 cuDNN
    convolutions, as a tuple whose first entry is the flow (NHWC): the
    net's tuple (the flow+occlusion nets: flow, occlusion; FlowNetCV: full,
    quarter flow), or ``(flow, None)``."""
    with torch.no_grad(), full_fp32_convs(torch.float32):
        out = model(x.float())
    return out if isinstance(out, tuple) else (out, None)
