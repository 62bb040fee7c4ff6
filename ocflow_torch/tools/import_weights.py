"""Import trained weights into the port: original OCFlow torch checkpoints
and the JAX package's ``.npz`` files -> port checkpoints that
``models.load_model`` (and so ``infer`` and ``evaluate --checkpoint``)
reads.

    python -m ocflow_torch.tools.import_weights --src DIR|FILE --out DIR \\
        [--network NAME]

Route 1, a torch checkpoint (``.pth``, ``.pt``, ``.ckpt``, ``.tar``): a
plain ``state_dict``, a Lightning checkpoint (``{"state_dict": ...}``, the
``model.`` / ``flow_pred.`` wrappers stripped) or a combined one
(``generator.`` + ``discriminator.``, ``occ_pred.``: one output per role).
Each (sub-)``state_dict`` is classified by its keys
(:func:`classify_state_dict`), mapped to the flax-layout tree by
``models.torch_convert`` and to the port's ``state_dict`` by the matching
``*_from_flax`` bridge of ``models.convert``: the two existing maps
composed, with no key map of its own. VGG16 and InceptionV3 files go to
``losses.perceptual.convert_torch_vgg16`` and
``metrics.inception.convert_torch_inception`` (``.npz`` outputs, loaded by
``weights_path`` and ``evaluate --inception_weights``).

Route 2, the JAX package's ``.npz`` (``<stem>.[<role>.]<network>.npz``, as
its weight tool names them): ``npz_to_variables``, then the same bridge.
The network comes from the file name, or from ``--network``, which takes
every name of :data:`NETWORKS` (``sanet_org`` and ``sa_discriminator_org``
included: key classification cannot tell them from ``sanet`` and
``sa_discriminator``).

Outputs: ``<stem>.[<role>.]<network>.pt`` (``{"params": state_dict}``,
``utils.checkpoint.save_pytree``) and ``manifest.json``, one entry per
output: ``source``, ``network``, ``role``, ``output``, ``source_sha256``,
``output_sha256`` (the fields of the JAX tool's manifest), and the
``family`` and ``key`` that ``load_model`` takes. Everything stays on the
CPU. A file that fails is reported and the rest go on; the process then
exits 1.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import shutil
import sys

from ocflow_torch.models import convert as bridges
from ocflow_torch.models import torch_convert as tc

# network -> (registry family, registry key, flax tree -> port state_dict)
NETWORKS = {
    "flownetcv": ("flow", "pwc", bridges.flownetcv_from_flax),
    "pwc": ("flow", "pwc", bridges.flownetcv_from_flax),
    "pwcnet": ("flow", "pwcnet", bridges.flownetcv_from_flax),
    "flownets": ("flow", "flownets", bridges.flownets_from_flax),
    "flownetc": ("flow", "flownetc", bridges.flownetc_from_flax),
    "simple": ("flow", "simple", bridges.simpleflownet_from_flax),
    "eflownet": ("flow", "eflownet", bridges.eflownet_from_flax),
    "eflownet2": ("flow", "eflownet2", bridges.eflownet_from_flax),
    "flownet_fpn": ("flow", "flownet", bridges.flownet_from_flax),
    "flow_occ_fpn": ("flow_occ", "flowoccnet", bridges.flowoccnet_from_flax),
    "flow_occ_cv": ("flow_occ", "pwoc", bridges.flowoccnetcv_from_flax),
    "flow_occ_cv2": ("flow_occ", "pwoc2", bridges.flowoccnetcv2_from_flax),
    "flow_occ_s": ("flow_occ", "flowoccnets", bridges.flowoccnets_from_flax),
    "flow_occ_c": ("flow_occ", "flowoccnetc", bridges.flowoccnetc_from_flax),
    "simple_flow_occ": ("flow_occ", "simple", bridges.simpleflowoccnet_from_flax),
    "simple_occ": ("occ", "simple", bridges.simpleoccnet_from_flax),
    "occ_s": ("occ", "occnets", bridges.occnets_from_flax),
    "occ_c": ("occ", "occnetc", bridges.occnetc_from_flax),
    "inpainting": ("inpainting", "simple", bridges.inpaintingnet_from_flax),
    "sanet": ("inpainting", "gated", bridges.inpaintsanet_from_flax),
    "sanet_org": ("inpainting", "gated_org", bridges.inpaintsanetorg_from_flax),
    "sa_discriminator": ("discriminator", "gated", bridges.discriminator_from_flax),
    "sa_discriminator_org": ("discriminator", "gated_org",
                             functools.partial(bridges.discriminator_from_flax,
                                               projected=False)),
}
# whole-file converters: their outputs are .npz files, not port checkpoints
NPZ_NETWORKS = ("vgg16", "inception")
SOURCE_SUFFIXES = (".pth", ".pt", ".ckpt", ".tar", ".npz")
ROLES = ("generator", "discriminator", "occ_pred")


def classify_state_dict(keys) -> str | None:
    """Map a (prefix-stripped) torch state_dict key set to a network name,
    or None when unrecognized. The JAX weight tool's signatures, most
    specific first, with two differences where that tool routes a full key
    set to a converter that then fails:

    - ``conv3_1.`` + ``predict_occ6.`` + ``upsampled_occ6_to_5.`` without
      ``predict_flow6.`` is OcclusionNetS (``occ_s``); the JAX tool tests
      ``predict_occ6.`` for FlowOccNetS first and calls it ``flow_occ_s``;
    - ``conv_redir.`` + ``predict_occ6.`` is FlowOccNetC (``flow_occ_c``)
      with ``predict_flow6.`` and OcclusionNetC (``occ_c``) without; the
      JAX tool calls the first ``flownetc`` and does not know the second.
    """
    ks = set(keys)

    def any_start(prefix):
        return any(k.startswith(prefix) for k in ks)

    if any_start("Conv2d_1a_3x3.conv."):
        return "inception"
    if any_start("features.0.") and any_start("features.28."):
        return "vgg16"
    if any_start("moduleExtractor.") or any_start("netExtractor."):
        return "pwcnet"
    if any_start("fe6_0."):
        return "flow_occ_cv2"
    if any_start("conv1a.") and any_start("predict_occ6."):
        return "flow_occ_cv"
    if any_start("conv1a."):
        return "flownetcv"
    if any_start("occlusion_estimators."):
        return "flow_occ_fpn"
    if any_start("feature_pyramid_network."):
        return "flownet_fpn"
    if any_start("bottleneck10."):
        return "eflownet2" if any_start("predict_flow3.") else "eflownet"
    if any_start("conv_redir."):
        if any_start("predict_occ6."):
            return "flow_occ_c" if any_start("predict_flow6.") else "occ_c"
        return "flownetc" if any_start("predict_flow6.") else None
    if any_start("conv3_1.") and any_start("predict_occ6."):
        if any_start("upsampled_occ6_to_5.") and not any_start("predict_flow6."):
            return "occ_s"
        return "flow_occ_s"
    if any_start("conv3_1.") and any_start("upsampled_occ6_to_5."):
        return "occ_s"
    if any_start("conv3_1."):
        return "flownets"
    if any_start("down1.") and any_start("predict_flow5."):
        return "simple_flow_occ" if any_start("predict_occ5.") else "simple"
    if any_start("down1.") and any_start("predict_occ5."):
        return "simple_occ"
    if any_start("down1.") and any_start("up6."):
        return "inpainting"
    if any_start("coarse_net.") or any_start("refine_conv_net."):
        return "sanet"
    if any_start("discriminator_net."):
        return "sa_discriminator"
    return None


_ROLE_PREFIXES = ("model.", "flow_pred.", "generator.", "discriminator.", "occ_pred.")


def _strip_roles(sd: dict) -> dict[str, dict]:
    """Split a (possibly combined) Lightning state_dict into role ->
    sub-dict: ``{'': sd}`` for a plain one, one entry per role
    (``generator.``, ``discriminator.``, ``occ_pred.``) for a combined one;
    ``model.`` / ``flow_pred.`` are wrappers, merged into ``''``."""
    roles: dict[str, dict] = {}
    for k, v in sd.items():
        for p in _ROLE_PREFIXES:
            if k.startswith(p):
                roles.setdefault(p, {})[k[len(p):]] = v
                break
        else:
            roles.setdefault("", {})[k] = v
    for p in ("model.", "flow_pred."):
        if p in roles:
            for r, d in _strip_roles(roles.pop(p)).items():
                roles.setdefault(r, {}).update(d)
    return roles


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _write(path: str, network: str, role: str, variables: dict, out_dir: str,
           stem: str) -> dict:
    from ocflow_torch.utils.checkpoint import save_pytree

    family, key, bridge = NETWORKS[network]
    tag = f"{role}." if role else ""
    out_path = os.path.join(out_dir, f"{stem}.{tag}{network}.pt")
    save_pytree(out_path, {"params": bridge(variables)})
    print(f"{path} [{role or 'root'}] -> {out_path} ({network}: {family}/{key})")
    return _entry(path, network, role, out_path, family, key)


def _entry(path, network, role, out_path, family=None, key=None) -> dict:
    return {"source": path, "network": network, "role": role, "output": out_path,
            "source_sha256": _sha256(path), "output_sha256": _sha256(out_path),
            "family": family, "key": key}


def _npz_name(path: str) -> tuple[str, str, str | None]:
    """``<stem>.[<role>.]<network>.npz`` -> (stem, role, network or None)."""
    parts = os.path.basename(path)[:-len(".npz")].split(".")
    network = parts.pop() if len(parts) > 1 else None
    role = parts.pop() if len(parts) > 1 and parts[-1] in ROLES else ""
    return ".".join(parts), role, network


def _flat(node: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in node.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def rejoin_spectral_norms(node):
    """``npz_to_variables`` splits every '/' of a flattened key, those
    inside a ``SpectralNorm_0`` node's own keys too (``Conv_0/kernel/u``,
    ``Conv_0/kernel/sigma``): join those back, as the converters made
    them."""
    if not isinstance(node, dict):
        return node
    return {k: _flat(v) if k.startswith("SpectralNorm") and isinstance(v, dict)
            else rejoin_spectral_norms(v) for k, v in node.items()}


def import_npz(path: str, out_dir: str, network: str | None = None) -> list[dict]:
    """Route 2: one ``.npz`` of the JAX package's weight tool -> one port
    checkpoint (VGG16 and InceptionV3 ``.npz`` are copied: the port reads
    them as they are)."""
    stem, role, named = _npz_name(path)
    network = network or named
    if network in NPZ_NETWORKS:
        out_path = os.path.join(out_dir, os.path.basename(path))
        if os.path.abspath(out_path) != os.path.abspath(path):
            shutil.copyfile(path, out_path)
        return [_entry(path, network, role, out_path)]
    if network not in NETWORKS:
        raise ValueError(f"{path}: no network in the file name "
                         f"(<stem>.[<role>.]<network>.npz) and no --network; "
                         f"networks: {sorted(NETWORKS)}")
    variables = rejoin_spectral_norms(tc.npz_to_variables(path))
    return [_write(path, network, role, variables, out_dir, stem)]


def _whole_file(path: str, network: str, out_dir: str, stem: str) -> dict:
    out_path = os.path.join(out_dir, f"{stem}.{network}.npz")
    if network == "vgg16":
        from ocflow_torch.losses.perceptual import convert_torch_vgg16
        convert_torch_vgg16(path, out_path)
    else:
        from ocflow_torch.metrics.inception import convert_torch_inception
        convert_torch_inception(path, out_path)
    print(f"{path} -> {out_path} ({network})")
    return _entry(path, network, "", out_path)


def convert_file(path: str, out_dir: str, network: str | None = None) -> list[dict]:
    """Import one checkpoint file; returns its manifest entries. With
    ``network``, the sub-module it implies (``torch_convert.select_role``)
    as that network; else every role, each as the network its keys say."""
    if path.endswith(".npz"):
        return import_npz(path, out_dir, network)
    sd = tc.load_state_dict(path)
    stem = os.path.splitext(os.path.basename(path))[0]
    if network in NPZ_NETWORKS:
        return [_whole_file(path, network, out_dir, stem)]
    if network is not None:
        if network not in NETWORKS:
            raise ValueError(f"unknown network {network!r}; networks: "
                             f"{sorted(NETWORKS) + list(NPZ_NETWORKS)}")
        variables = tc.CONVERTERS[network](tc.select_role(sd, network))
        return [_write(path, network, "", variables, out_dir, stem)]
    entries = []
    for role, sub in _strip_roles(sd).items():
        name = classify_state_dict(sub.keys())
        if name in NPZ_NETWORKS and role == "":
            return [_whole_file(path, name, out_dir, stem)]
        if name is None or name in NPZ_NETWORKS:
            print(f"skip {path} role={role!r}: unrecognized keys "
                  f"(e.g. {sorted(sub)[:3]})", file=sys.stderr)
            continue
        entries.append(_write(path, name, role.rstrip("."), tc.CONVERTERS[name](sub),
                              out_dir, stem))
    return entries


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True,
                    help="a directory of .pth/.pt/.ckpt/.tar/.npz files, or one file")
    ap.add_argument("--out", default="weights",
                    help="output directory for the port checkpoints and manifest.json")
    ap.add_argument("--network", default=None,
                    choices=sorted(NETWORKS) + list(NPZ_NETWORKS),
                    help="the network of every file, in place of key classification "
                         "or the .npz file name")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    if os.path.isfile(args.src):
        files = [args.src]
    else:
        files = sorted(os.path.join(args.src, f) for f in os.listdir(args.src)
                       if f.endswith(SOURCE_SUFFIXES))
    manifest, failed = [], []
    for path in files:
        try:
            manifest.extend(convert_file(path, args.out, args.network))
        except Exception as e:  # keep going; report at the end
            print(f"FAILED {path}: {type(e).__name__}: {e}", file=sys.stderr)
            failed.append(path)
    man_path = os.path.join(args.out, "manifest.json")
    with open(man_path, "w") as f:
        json.dump(manifest, f, indent=2)
    print(f"{len(manifest)} imports -> {man_path}")
    if failed:
        raise SystemExit(f"{len(failed)} of {len(files)} files failed: {failed}")
    return manifest


if __name__ == "__main__":
    main()
