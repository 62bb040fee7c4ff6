"""Importing trained weights into the port (``ocflow_torch.models.torch_convert``
and ``ocflow_torch.tools.import_weights``) against the JAX package's
converters (``ocflow_tpu.models.torch_convert``) and weight tool
(``tools/convert_all_weights.py``), on the CPU.

The original-layout checkpoints are made here from the port's seeded nets
(BatchNorm statistics perturbed): the port's ``state_dict`` is the original
one but for three families, which are rewritten to the originals' layout --
PWC-Net to the raw sniklaus names (``moduleExtractor.moduleOne...``), the
FlowNetS family without its up-deconv biases, the discriminators to torch's
``spectral_norm`` tensors (``weight_orig``, ``weight_u``, ``weight_v``);
FlowNetCV gets the original's dead ``deconv2``. For every converter name:

- the JAX converter accepts the ``state_dict`` (it raises on any key
  missing or left over);
- the port's ``torch_convert`` tree equals the JAX tree bit for bit (paths,
  dtypes, values);
- the import of the checkpoint (plain, Lightning-wrapped or a role of a
  combined one) and (but for the six largest nets) of the JAX tree's
  ``.npz`` equals ``*_from_flax`` of the JAX tree bit for bit and loads
  into the registry's net with ``strict``;
- the classification equals the JAX tool's, but where that tool routes a
  full key set to a converter that fails (``occ_s``; ``flow_occ_c`` and
  ``occ_c``, which it does not know), shown here.

Also: test_misc's key lists and role splitting against the JAX tool; the
CLI's manifest against the JAX tool's ``main`` on one directory; VGG16 and
InceptionV3 ``.npz`` against the JAX converters (the JAX tool itself fails
on such files); and three forwards after
import (PWC-Net from the sniklaus names, FlowNetS, the discriminator)
against the JAX forward on the JAX tree within ``FORWARD_REL`` of max|out|
(fp32, summation order).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from ocflow_torch.bench import perturb_batchnorm
from ocflow_torch.models import build
from ocflow_torch.models import torch_convert as tc
from ocflow_torch.models.pwc_net import encoder_names
from ocflow_torch.tools import import_weights as iw
from ocflow_torch.utils.checkpoint import load_pytree
from ocflow_tpu.models import torch_convert as jtc
from test_torch_ops import share_cores  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import convert_all_weights as caw  # noqa: E402

FORWARD_REL = 1e-4
JAX_CONVERTERS = {**caw._converters(),
                  "flow_occ_c": jtc.convert_flow_occ_net_c,
                  "occ_c": jtc.convert_occlusion_net_c,
                  "sanet_org": lambda sd: jtc.convert_inpaint_sanet(sd, projected=False),
                  "sa_discriminator_org": lambda sd: jtc.convert_inpaint_discriminator(
                      sd, projected=False)}
# the 18 names of the JAX tool, then the networks only --network or this
# port's classifier reaches
NETWORKS = list(caw._converters()) + ["flow_occ_c", "occ_c", "sanet_org",
                                      "sa_discriminator_org"]
# where the JAX tool's classifier differs: it routes these full key sets to
# a converter that fails, or to none
JAX_CLASSIFIES = {"occ_s": "flow_occ_s", "flow_occ_c": "flownetc", "occ_c": None,
                  "sanet_org": "sanet", "sa_discriminator_org": "sa_discriminator"}
# how each case's checkpoint is wrapped: plain, Lightning, or a role
WRAP = {"flownetcv": "model.", "flownets": "flow_pred.", "simple_occ": "occ_pred.",
        "occ_s": "occ_pred.", "sanet": "generator.", "sa_discriminator": "discriminator.",
        "inpainting": "generator."}
_LEVEL = ("One", "Two", "Thr", "Fou", "Fiv", "Six")
# the FlowNetS and FlowNetC families (~39M parameters each: their .npz route is
# the same code as the smaller nets', and each costs seconds of file IO)
LARGE = ("flownets", "flownetc", "flow_occ_s", "occ_s", "flow_occ_c", "occ_c")


def sniklaus(sd: dict) -> dict:
    """The port PWCNet's ``state_dict`` (FlowNetCV's names) under the raw
    sniklaus checkpoint's names."""
    out = {}

    def put(src, dst):
        for t in ("weight", "bias"):
            out[f"{dst}.{t}"] = sd[f"{src}.{t}"]

    for i, name in enumerate(encoder_names()):
        put(f"{name}.0", f"moduleExtractor.module{_LEVEL[i // 3]}.{2 * (i % 3)}")
    for lvl in (6, 5, 4, 3, 2):
        dec = f"module{_LEVEL[lvl - 1]}"
        for j in range(5):
            put(f"conv{lvl}_{j}.0", f"{dec}.module{_LEVEL[j]}.0")
        put(f"predict_flow{lvl}", f"{dec}.moduleSix.0")
        if lvl < 6:
            put(f"deconv{lvl + 1}", f"{dec}.moduleUpflow")
            put(f"upfeat{lvl + 1}", f"{dec}.moduleUpfeat")
    for j in range(6):
        put(f"dc_conv{j + 1}.0", f"moduleRefiner.moduleMain.{2 * j}")
    put("dc_conv7", "moduleRefiner.moduleMain.12")
    assert 2 * len({k.rsplit(".", 1)[0] for k in sd}) == len(out) == len(sd)
    return out


def torch_spectral_norm(sd: dict, generator: torch.Generator) -> dict:
    """The port's ``SNConv2d`` tensors (``weight``, ``u``, ``sigma``) as
    ``torch.nn.utils.spectral_norm`` stores them (``weight_orig``,
    ``weight_u``, ``weight_v``)."""
    out = {}
    for k, v in sd.items():
        base = k.rsplit(".", 1)[0]
        if k.endswith(".sigma"):
            continue
        if k.endswith(".u"):
            out[f"{base}.weight_u"] = v.reshape(-1)
        elif k.endswith(".weight") and f"{base}.u" in sd:
            out[f"{base}.weight_orig"] = v
            vec = torch.randn(v[0].numel(), generator=generator)
            out[f"{base}.weight_v"] = vec / vec.norm()
        else:
            out[k] = v
    return out


def original_state_dict(network: str, seed: int = 0) -> dict:
    """A seeded original-layout ``state_dict`` of ``network`` (torch's
    default init from ``seed``: the flax-style seeded init of the largest
    nets takes seconds on the CPU)."""
    family, key, _ = iw.NETWORKS[network]
    torch.manual_seed(seed)
    model = build(family, key)
    perturb_batchnorm(model, torch.Generator().manual_seed(seed + 100))
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    if network == "pwcnet":
        sd = sniklaus(sd)
    if network in ("flownets", "flow_occ_s", "occ_s"):
        sd = {k: v for k, v in sd.items()
              if not (k.startswith("upsampled_") and k.endswith(".bias"))}
    if network.startswith("sa_discriminator"):
        sd = torch_spectral_norm(sd, torch.Generator().manual_seed(seed + 200))
    if network == "flownetcv":  # the original's unused level-2 deconv
        sd["deconv2.weight"] = torch.randn(2, 2, 4, 4)
        sd["deconv2.bias"] = torch.randn(2)
    return sd


def leaves(tree, prefix=""):
    """``{'/'-joined path: array}`` of a nested dict."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(leaves(v, path) if isinstance(v, dict) else {path: v})
    return out


def assert_trees_equal(got: dict, want: dict):
    got, want = leaves(got), leaves(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k


def assert_state_dicts_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


def _save(path, sd, network):
    wrap = WRAP.get(network, "")
    sd = {wrap + k: v for k, v in sd.items()}
    torch.save({"state_dict": sd, "hyper_parameters": {"lr": 1e-4}} if wrap else sd, path)


@pytest.mark.parametrize("network", NETWORKS)
def test_import_matches_jax_converters(tmp_path, network):
    sd = original_state_dict(network)
    jax_tree = JAX_CONVERTERS[network](sd)  # raises on a key missing or left over
    assert_trees_equal(tc.CONVERTERS[network](sd), jax_tree)
    family, key, bridge = iw.NETWORKS[network]
    want = bridge(jax_tree)

    assert iw.classify_state_dict(sd) == (network if not network.endswith("_org")
                                          else network[:-4])
    assert caw.classify_state_dict(sd) == JAX_CLASSIFIES.get(network, network)

    # route 1: the checkpoint file (classified, or named where keys cannot tell)
    src = str(tmp_path / "trained.ckpt")
    _save(src, sd, network)
    out = tmp_path / "out"
    out.mkdir()
    named = network if network.endswith("_org") else None
    (entry,) = iw.convert_file(src, str(out), named)
    role = WRAP.get(network, "").rstrip(".")
    role = role if role in iw.ROLES and named is None else ""
    assert (entry["network"], entry["role"], entry["family"], entry["key"]) == (
        network, role, family, key)
    assert entry["output"] == str(out / f"trained.{role + '.' if role else ''}{network}.pt")
    tree = load_pytree(entry["output"])
    assert_state_dicts_equal(tree["params"], want)
    with torch.device("meta"):  # the keys and shapes checked, no init drawn
        model = build(family, key)
    model.load_state_dict(tree["params"], strict=True, assign=True)



@pytest.mark.parametrize("network", [n for n in NETWORKS if n not in LARGE])
def test_import_of_jax_npz(tmp_path, network):
    """Route 2: the JAX tool's ``.npz`` of the JAX tree, named as that tool
    names them, imports to ``*_from_flax`` of the tree (the spectral norms'
    '/'-joined keys included)."""
    sd = original_state_dict(network)
    jax_tree = JAX_CONVERTERS[network](sd)
    family, key, bridge = iw.NETWORKS[network]
    role = WRAP.get(network, "").rstrip(".")
    role = role if role in iw.ROLES else ""
    npz = str(tmp_path / f"trained.{role + '.' if role else ''}{network}.npz")
    jtc.variables_to_npz(jax_tree, npz)
    (entry,) = iw.convert_file(npz, str(tmp_path))
    assert (entry["network"], entry["role"], entry["family"], entry["key"]) == (
        network, role, family, key)
    tree = load_pytree(entry["output"])
    assert_state_dicts_equal(tree["params"], bridge(jax_tree))
    with torch.device("meta"):
        model = build(family, key)
    model.load_state_dict(tree["params"], strict=True, assign=True)


def test_jax_tool_fails_on_a_full_occ_s_checkpoint(tmp_path):
    """The JAX tool tests ``predict_occ6.`` for FlowOccNetS before it tests
    OcclusionNetS: a real OcclusionNetS checkpoint goes to
    ``convert_flow_occ_net_s``, which raises on the missing ``predict_flow*``
    keys (its main prints ``FAILED``); the port imports it."""
    sd = original_state_dict("occ_s")
    src = tmp_path / "occ_s.pth"
    torch.save(sd, src)
    assert caw.classify_state_dict(sd) == "flow_occ_s"
    with pytest.raises(KeyError, match="predict_flow"):
        caw.convert_file(str(src), str(tmp_path))
    (entry,) = iw.convert_file(str(src), str(tmp_path))
    assert (entry["network"], entry["family"], entry["key"]) == ("occ_s", "occ", "occnets")


# tests/test_misc.py::test_classify_state_dict_signatures's key lists
MISC_KEYS = {
    "pwcnet": ["moduleExtractor.moduleOne.0.weight"],
    "flownetcv": ["conv1a.0.weight", "predict_flow6.weight"],
    "flow_occ_cv": ["conv1a.0.weight", "predict_occ6.0.weight"],
    "flow_occ_cv2": ["fe6_0.0.weight", "oe6_0.0.weight"],
    "flownet_fpn": ["feature_pyramid_network.layer1.double_conv.0.weight",
                    "opticalflow_estimators.0.conv1.weight"],
    "flow_occ_fpn": ["feature_pyramid_network.layer1.double_conv.0.weight",
                     "occlusion_estimators.0.conv1.weight"],
    "eflownet": ["bottleneck10.conv1.weight", "predict_flow.weight"],
    "eflownet2": ["bottleneck10.conv1.weight", "predict_flow3.weight"],
    "flownetc": ["conv_redir.0.weight", "predict_flow6.weight"],
    "flownets": ["conv3_1.0.weight", "predict_flow6.weight"],
    "occ_s": ["conv3_1.0.weight", "upsampled_occ6_to_5.weight"],
    "flow_occ_s": ["conv3_1.0.weight", "predict_occ6.0.weight"],
    "simple": ["down1.conv1.weight", "predict_flow5.0.0.weight"],
    "simple_flow_occ": ["down1.conv1.weight", "predict_flow5.0.0.weight",
                        "predict_occ5.0.0.weight"],
    "simple_occ": ["down1.conv1.weight", "predict_occ5.0.0.weight"],
    "inpainting": ["down1.conv1.weight", "up6.conv1.weight"],
    "sanet": ["coarse_net.0.conv2d.weight"],
    "sa_discriminator": ["discriminator_net.0.conv2d.weight"],
    "vgg16": [f"features.{i}.weight" for i in (0, 2, 28)],
    "inception": ["Conv2d_1a_3x3.conv.weight"],
}


@pytest.mark.parametrize("want", list(MISC_KEYS))
def test_classify_matches_jax_on_test_misc_keys(want):
    keys = MISC_KEYS[want]
    assert iw.classify_state_dict(keys) == caw.classify_state_dict(keys) == want
    assert iw.classify_state_dict(["unknown.weight"]) is None


def _combined(tmp_path):
    """A directory of checkpoints the JAX tool converts: a plain FlowNetCV,
    a Lightning GAN checkpoint (``generator.`` + ``discriminator.``) and a
    two-stage one (``model.`` wrapping ``occ_pred.``)."""
    src = tmp_path / "ckpts"
    src.mkdir()
    torch.save(original_state_dict("flownetcv"), src / "pwc_trained.pth")
    gan = {**{f"generator.{k}": v for k, v in original_state_dict("sanet").items()},
           **{f"discriminator.{k}": v
              for k, v in original_state_dict("sa_discriminator").items()}}
    torch.save({"state_dict": gan, "epoch": 3}, src / "gan.ckpt")
    occ = {f"model.occ_pred.{k}": v for k, v in original_state_dict("simple_occ").items()}
    torch.save({"state_dict": occ}, src / "two_stage.ckpt")
    return src, {"gan.ckpt": gan, "two_stage.ckpt": occ}


def test_role_splitting_and_manifest_match_jax_main(tmp_path):
    src, combined = _combined(tmp_path)
    for sd in combined.values():
        got, want = iw._strip_roles(sd), caw._strip_roles(sd)
        assert {r: sorted(d) for r, d in got.items()} == {r: sorted(d) for r, d in want.items()}
    jout, pout = tmp_path / "jax", tmp_path / "port"
    want = caw.main(["--src", str(src), "--out", str(jout)])
    got = iw.main(["--src", str(src), "--out", str(pout)])
    fields = ("source", "network", "role", "source_sha256")
    assert [tuple(e[f] for f in fields) for e in got] == [tuple(e[f] for f in fields)
                                                          for e in want]
    assert json.load(open(pout / "manifest.json")) == got
    assert len(got) == 4
    for g, w in zip(got, want):
        _, _, bridge = iw.NETWORKS[g["network"]]
        tree = load_pytree(g["output"])
        want_sd = bridge(iw.rejoin_spectral_norms(jtc.npz_to_variables(w["output"])))
        assert_state_dicts_equal(tree["params"], want_sd)
        assert g["output_sha256"] == iw._sha256(g["output"])
        assert (g["family"], g["key"]) == iw.NETWORKS[g["network"]][:2]

    # the CLI as a process: an explicit --network on one role of the GAN
    # checkpoint, and an unreadable file reported with exit status 1
    (src / "junk.pth").write_bytes(b"not a checkpoint")
    proc = subprocess.run([sys.executable, "-m", "ocflow_torch.tools.import_weights",
                           "--src", str(src), "--out", str(tmp_path / "cli"),
                           "--network", "sa_discriminator"],
                          cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 1 and "FAILED" in proc.stderr and "junk.pth" in proc.stderr
    manifest = json.load(open(tmp_path / "cli" / "manifest.json"))
    gan = [e for e in manifest if e["source"].endswith("gan.ckpt")]
    assert [(e["network"], e["family"], e["key"]) for e in gan] == [
        ("sa_discriminator", "discriminator", "gated")]


def test_vgg16_and_inception_match_jax_converters(tmp_path):
    from ocflow_torch.losses.perceptual import VGG16Features
    from ocflow_torch.metrics.inception import InceptionV3
    from ocflow_tpu.losses.perceptual import convert_torch_vgg16
    from ocflow_tpu.metrics.inception import convert_torch_inception

    g = torch.Generator().manual_seed(0)
    vgg = dict(VGG16Features(generator=g).state_dict())
    for i in (24, 26, 28):  # torchvision's last block, which the loss does not read
        vgg[f"features.{i}.weight"] = torch.randn(4, 4, 3, 3, generator=g)
        vgg[f"features.{i}.bias"] = torch.randn(4, generator=g)
    torch.manual_seed(0)
    inception = InceptionV3()
    perturb_batchnorm(inception, torch.Generator().manual_seed(1))
    for name, sd, convert in (("vgg16", vgg, convert_torch_vgg16),
                              ("inception", inception.state_dict(), convert_torch_inception)):
        src = str(tmp_path / f"{name}.pth")
        torch.save(sd, src)
        # the JAX tool classifies the file and has no converter under that
        # name (its whole-file branch is reached only for unknown keys)
        with pytest.raises(KeyError, match=name):
            caw.convert_file(src, str(tmp_path))
        (entry,) = iw.convert_file(src, str(tmp_path))
        assert (entry["network"], entry["family"]) == (name, None)
        want = str(tmp_path / f"{name}_jax.npz")
        convert(src, want)
        got, ref = np.load(entry["output"]), np.load(want)
        assert sorted(got.files) == sorted(ref.files)
        for k in ref.files:
            assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), (name, k)
        (tmp_path / name).mkdir()
        (again,) = iw.convert_file(entry["output"], str(tmp_path / name), name)  # route 2
        assert iw._sha256(again["output"]) == iw._sha256(entry["output"])


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


@pytest.mark.parametrize("network", ["pwcnet", "flownets", "sa_discriminator"])
def test_forward_after_import_matches_jax(tmp_path, network):
    from ocflow_tpu.models import flow_net_s as jfns
    from ocflow_tpu.models import gated_conv as jg
    from ocflow_tpu.models import pwc_net as jpwc

    sd = original_state_dict(network, seed=1)
    src = str(tmp_path / "w.pth")
    torch.save(sd, src)
    (entry,) = iw.convert_file(src, str(tmp_path))
    family, key, _ = iw.NETWORKS[network]
    model = build(family, key)
    model.load_state_dict(load_pytree(entry["output"])["params"])
    model.eval()
    variables = JAX_CONVERTERS[network](sd)
    rng = np.random.default_rng(7)
    if network == "sa_discriminator":
        x = rng.uniform(-1, 1, (2, 64, 128, 4)).astype(np.float32)
        ref = jax.jit(lambda v, a: jg.InpaintSADiscriminator().apply(v, a))(variables, x)
    else:
        x = rng.uniform(-1, 1, (2, 64, 128, 6)).astype(np.float32)
        net = jpwc.PWCNet() if network == "pwcnet" else jfns.FlowNetS()
        ref = jax.jit(lambda v, a: net.apply(v, a, train=False))(variables, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == tuple(r.shape)
        assert _rel(g.numpy(), r) <= FORWARD_REL, network
