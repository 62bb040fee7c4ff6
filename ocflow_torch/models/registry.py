"""String-key model registry (port of ``ocflow_tpu/models/registry.py``):
``build(family, key, **kwargs)`` returns a port module, for the keys the
port has. Unknown families and keys raise, listing what is available.
"""

from __future__ import annotations

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
