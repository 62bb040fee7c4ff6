"""String-key model registry (port of ``ocflow_tpu/models/registry.py``):
``build(family, key, **kwargs)`` returns a port module, for the keys the
port has. Unknown families and keys raise, listing what is available.
``load_model`` builds one for serving (seeded or from a checkpoint, eval
mode) and ``predict`` runs its eager fp32 forward, as both CLIs serve it.
"""

from __future__ import annotations

import torch

from ocflow_torch import full_fp32_convs
from ocflow_torch.models.flow_net_s import FlowNetC
from ocflow_torch.models.flow_occ_nets import FlowOccNetC
from ocflow_torch.models.occlusion_nets import OcclusionNetC
from ocflow_torch.models.pwc_net import FlowNetCV, PWCNet

_REGISTRY = {
    "flow": {"pwc": FlowNetCV, "pwcnet": PWCNet, "flownetc": FlowNetC},
    "occ": {"occnetc": OcclusionNetC},
    "flow_occ": {"flowoccnetc": FlowOccNetC},
}


def available() -> dict[str, list[str]]:
    """``{family: [keys]}`` of every model the port builds."""
    return {f: sorted(keys) for f, keys in _REGISTRY.items()}


def build(family: str, key: str, **kwargs):
    """The module registered under ``family``/``key``, built with
    ``kwargs`` (e.g. ``generator=`` for a seeded init, ``device=``)."""
    if family not in _REGISTRY:
        raise ValueError(f"unknown model family {family!r}; the port has {available()}")
    if key not in _REGISTRY[family]:
        raise ValueError(f"unknown model {key!r} in family {family!r}; the port "
                         f"has {available()}")
    return _REGISTRY[family][key](**kwargs)


def load_model(family: str, key: str, checkpoint: str = "", device=None) -> torch.nn.Module:
    """The network ``build(family, key)`` on ``device`` in eval mode:
    seeded from 0, or with the ``params`` of a port checkpoint. Keys the
    port does not have raise ``NotImplementedError`` naming ROADMAP A9."""
    # imported here: utils.checkpoint imports the train package, which
    # imports the models
    from ocflow_torch.utils.checkpoint import load_subtree

    try:
        model = build(family, key, generator=torch.Generator().manual_seed(0))
    except ValueError as e:
        raise NotImplementedError(
            f"{e}; the rest of the flow and occlusion zoo is ROADMAP A9") from None
    if checkpoint:
        model.load_state_dict(load_subtree(checkpoint, "params"))
    return model.to(device).eval()


def predict(model: torch.nn.Module, x: torch.Tensor) -> tuple:
    """The eager fp32 forward of ``[B, H, W, 6]`` frames, full fp32 cuDNN
    convolutions, as a tuple whose first entry is the flow (NHWC): the
    net's tuple (FlowOccNetC: flow, occlusion; FlowNetCV: full, quarter
    flow), or ``(flow, None)``."""
    with torch.no_grad(), full_fp32_convs(torch.float32):
        out = model(x.float())
    return out if isinstance(out, tuple) else (out, None)
