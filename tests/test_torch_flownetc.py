"""The port's FlowNetC family (FlowNetC, OcclusionNetC, FlowOccNetC) and its
d=10 cost volume == the JAX modules and kernel.

Seeded port weights (BatchNorm statistics perturbed from a seed, as the
seeded init starts BatchNorm at the identity) are mapped to flax
variables through the JAX package's ``convert_flownetc`` /
``convert_occlusion_net_c`` / ``convert_flow_occ_net_c``; both packages run
the same seeded fp32 input on the CPU in eval mode (``train=False``).
Whole-net bound: max-abs <= 1e-4 of max|JAX output| on flow and occlusion,
as tests/test_parity_networks.py holds the JAX FlowNetC to the reference
(only summation order differs). The cost volume: 1e-5 absolute on O(1)
values against the Pallas kernel in interpret mode, and bit-equal to the
port's plain op (the wrapper runs it for CPU tensors).
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocflow_torch.bench import perturb_batchnorm
from ocflow_torch.kernels import cost_volume as cv_mod
from ocflow_torch.models import (EFlowNet, EFlowNet2, FlowNet, FlowNetC, FlowNetCV,
                                 FlowNetS, FlowOccNet, FlowOccNetC, FlowOccNetCV,
                                 FlowOccNetCV2, FlowOccNetS, InpaintSADiscriminatorOrg,
                                 InpaintSANet, InpaintingNet, OCFlowNet,
                                 OcclusionNetC, OcclusionNetS, PWCNet, SimpleFlowNet,
                                 SimpleFlowOccNet, SimpleOcclusionNet, available, build,
                                 flownetc_from_flax, flowoccnetc_from_flax, occnetc_from_flax)
from ocflow_torch.ops.cost_volume import cost_volume as plain_cost_volume
from ocflow_tpu.models import flow_net_s as jfns
from ocflow_tpu.models import flow_occ_nets as jfon
from ocflow_tpu.models import occlusion_nets as jocc
from ocflow_tpu.models.torch_convert import (convert_flow_occ_net_c, convert_flownetc,
                                             convert_occlusion_net_c)
from ocflow_tpu.ops.cost_volume import cost_volume as j_cost_volume
from ocflow_tpu.ops.pallas.cost_volume_kernel import _forward_pallas
from test_torch_ops import share_cores  # noqa: F401  (autouse)

REL_TOL = 1e-4
NETS = {
    "flownetc": (FlowNetC, jfns.FlowNetC, convert_flownetc, flownetc_from_flax),
    "occnetc": (OcclusionNetC, jocc.OcclusionNetC, convert_occlusion_net_c,
                occnetc_from_flax),
    "flowoccnetc": (FlowOccNetC, jfon.FlowOccNetC, convert_flow_occ_net_c,
                    flowoccnetc_from_flax),
}
# sha256 over (key, fp32 bytes) of FlowNetCV(generator seed 0)'s state_dict,
# as the init draws it from flax's distribution (truncated LeCun-normal
# weights, fan-in cin*kh*kw for transposed convs too, zero biases)
FLOWNETCV_SEED0_SHA256 = "8c46587034c2778d9b219a42a8629f1817d452f20561c74d6f1865e23fcb15fa"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("shape, reference", [((2, 12, 40, 24), "pallas"),
                                              ((2, 12, 40, 13), "xla")])
def test_cost_volume_d10_matches_jax_and_plain(shape, reference):
    """NHWC shapes with H under 2d+1 = 21 (most shifts read the zero
    padding), W not a multiple of 32, and C both a multiple of the d=10
    kernel's 8-channel chunk and not. The reference is the Pallas kernel in
    interpret mode (~30 s on the CPU at 441 shifts), or for the second
    shape the JAX package's XLA cost volume, which the Pallas kernel is held
    to in its own tests."""
    rng = np.random.default_rng(sum(shape))
    d = 10
    f1 = rng.normal(size=shape).astype(np.float32)
    f2 = rng.normal(size=shape).astype(np.float32)
    if reference == "pallas":
        ref = np.asarray(_forward_pallas(jnp.asarray(f1), jnp.asarray(f2), d,
                                         interpret=True, transpose_out=False))
    else:
        ref = np.asarray(j_cost_volume(jnp.asarray(f1), jnp.asarray(f2), d)
                         ).transpose(0, 3, 1, 2)
    t1, t2 = (_t(a.transpose(0, 3, 1, 2)) for a in (f1, f2))
    got = cv_mod.cost_volume(t1, t2, d)
    b, h, w, _ = shape
    assert got.shape == (b, 441, h, w)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    np.testing.assert_array_equal(got.numpy(), plain_cost_volume(t1, t2, d).numpy())


@pytest.mark.parametrize("key", NETS)
def test_forward_matches_jax(key):
    port_cls, jax_cls, convert, _ = NETS[key]
    model = port_cls(generator=torch.Generator().manual_seed(0)).eval()
    perturb_batchnorm(model, torch.Generator().manual_seed(1))
    variables = convert(model.state_dict())
    assert set(variables) == {"params", "batch_stats"}
    x = np.random.default_rng(1).uniform(-1, 1, (2, 128, 128, 6)).astype(np.float32)
    ref = _tuple(jax.jit(lambda v, a: jax_cls().apply(v, a, train=False))(
        variables, jnp.asarray(x)))
    cv_mod.cost_volume.launches = 0
    with torch.no_grad():
        got = _tuple(model(torch.from_numpy(x)))
    assert cv_mod.cost_volume.launches == 0  # CPU tensors: the plain op
    assert len(got) == len(ref) == len(port_cls.HEADS)
    for g, r, head in zip(got, ref, port_cls.HEADS):
        r = np.asarray(r)
        assert g.shape == r.shape == (2, 128, 128, 2 if head == "flow" else 1)
        assert g.dtype == torch.float32
        err = np.abs(g.numpy() - r).max()
        assert err <= REL_TOL * np.abs(r).max(), (head, err, np.abs(r).max())


@pytest.mark.parametrize("key", NETS)
def test_from_flax_round_trip(key):
    """flax variables -> port state_dict (loads strictly into the module)
    -> the JAX package's converter -> identical trees, BatchNorm statistics
    included."""
    port_cls, jax_cls, convert, from_flax = NETS[key]
    shapes = jax.eval_shape(jax_cls().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 6)))
    rng = np.random.default_rng(7)

    def fill(path, s):
        leaf = rng.normal(size=s.shape).astype(np.float32)
        return np.abs(leaf) + 0.5 if path[-1].key == "var" else leaf

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    assert set(variables) == {"params", "batch_stats"}
    sd = from_flax(variables)
    port_cls().load_state_dict(sd)  # every key and shape fits the module
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(convert(sd)))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)


def test_flownetcv_seeded_weights_unchanged():
    """FlowNetCV's seeded draws (3x3 convs with biases and 4x4 transposed
    convs, no BatchNorm) are pinned: the init's draw order and
    distribution do not move unnoticed."""
    sd = FlowNetCV(generator=torch.Generator().manual_seed(0)).state_dict()
    h = hashlib.sha256()
    for k, v in sd.items():
        h.update(k.encode())
        h.update(v.contiguous().numpy().tobytes())
    assert h.hexdigest() == FLOWNETCV_SEED0_SHA256


def test_seeded_batchnorm_is_not_the_identity():
    """The contract since the init draws from flax's distribution: seeded
    BatchNorm starts at the identity (scale 1, bias 0, running mean 0,
    variance 1, as flax's ``init``); a check that needs eval-mode
    BatchNorm that is not the identity perturbs it from a seed
    (``bench.perturb_batchnorm``), and then it is not."""
    model = FlowNetC(generator=torch.Generator().manual_seed(0)).requires_grad_(False)
    bn = model.conv3_1[1]
    assert model.conv3_1[0].bias is None and model.conv3_1[0].in_channels == 473
    for t, v in ((bn.weight, 1.0), (bn.bias, 0.0), (bn.running_mean, 0.0),
                 (bn.running_var, 1.0)):
        assert torch.equal(t, torch.full_like(t, v))
    conv1 = model.conv1[0].weight  # 7x7: fan-in 3 * 49
    assert abs(float(conv1.std()) * np.sqrt(3 * 49) - 1) < 0.05
    perturb_batchnorm(model, torch.Generator().manual_seed(0))
    for t, lo, hi in ((bn.weight, 0.5, 1.5), (bn.bias, -0.1, 0.1),
                      (bn.running_mean, -0.1, 0.1), (bn.running_var, 0.5, 2.0)):
        assert lo <= float(t.min()) < float(t.max()) <= hi
    x = torch.randn(2, 256, 4, 5, generator=torch.Generator().manual_seed(1))
    assert (bn.eval()(x) - x).abs().max() > 0.1


def test_registry_builds_each_key_and_raises_on_unknown():
    want = {("flow", "pwc"): FlowNetCV, ("flow", "pwcnet"): PWCNet,
            ("flow", "flownetc"): FlowNetC, ("occ", "occnetc"): OcclusionNetC,
            ("flow_occ", "flowoccnetc"): FlowOccNetC, ("flow", "simple"): SimpleFlowNet,
            ("flow", "flownet"): FlowNet, ("flow_occ", "pwoc"): FlowOccNetCV,
            ("flow_occ", "pwoc2"): FlowOccNetCV2, ("flow_occ", "flowoccnet"): FlowOccNet,
            ("flow", "flownets"): FlowNetS, ("flow", "eflownet"): EFlowNet,
            ("flow", "eflownet2"): EFlowNet2, ("occ", "simple"): SimpleOcclusionNet,
            ("occ", "occnets"): OcclusionNetS, ("flow_occ", "simple"): SimpleFlowOccNet,
            ("flow_occ", "flowoccnets"): FlowOccNetS}
    assert available() == {
        "flow": ["eflownet", "eflownet2", "flownet", "flownetc", "flownets", "pwc", "pwcnet",
                 "simple"],
        "occ": ["occnetc", "occnets", "simple"],
        "flow_occ": ["flowoccnet", "flowoccnetc", "flowoccnets", "pwoc", "pwoc2", "simple"],
        "inpainting": ["gated", "gated_org", "simple"], "discriminator": ["gated", "gated_org"],
        "pipeline": ["ocflownet"]}
    for (family, key), cls in want.items():
        assert type(build(family, key)) is cls
    a = build("flow", "flownetc", generator=torch.Generator().manual_seed(3))
    b = FlowNetC(generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    with pytest.raises(ValueError, match="ocflownet.*'occnetc'"):
        build("flow", "ocflownet")
    # the inpainting, discriminator and pipeline families are ported
    assert type(build("inpainting", "simple")) is InpaintingNet
    assert type(build("pipeline", "ocflownet")) is OCFlowNet
    assert type(build("inpainting", "gated")) is InpaintSANet
    assert type(build("discriminator", "gated_org")) is InpaintSADiscriminatorOrg
    with pytest.raises(ValueError, match="'simple'"):
        build("occ", "gated")


def test_fp32_forward_pins_cudnn_convolutions_to_fp32(monkeypatch):
    """The three forwards run their convolutions and transposed
    convolutions with TF32 off in fp32, whatever the caller's flag, and give
    the flag back."""
    seen = []

    def spy(fn):
        def run(*args, **kwargs):
            seen.append(torch.backends.cudnn.allow_tf32)
            return fn(*args, **kwargs)
        return run

    for name in ("conv2d", "conv_transpose2d"):
        monkeypatch.setattr(torch.nn.functional, name,
                            spy(getattr(torch.nn.functional, name)))
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for cls in (FlowNetC, OcclusionNetC, FlowOccNetC):
            seen.clear()
            with torch.no_grad():
                cls().eval()(torch.zeros(1, 64, 64, 6))
            # 14 trunk convs, 5 per head; 4 feature deconvs, 4 per head
            assert len(seen) == 18 + len(cls.HEADS) * 9 and not any(seen), cls
            assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def test_kernel_wrappers_check_the_displacement_before_launching():
    """Off the CPU the forward and the backward take every d from 1 (the
    tuned kernels up to ``MAX_DISPLACEMENT`` = 10, the general kernels
    above) and refuse d = 0 with their own message (meta tensors reach the
    checks without a card; a valid d then fails the device check)."""
    f = torch.empty(1, 8, 5, 6, device="meta")
    assert cv_mod.MAX_DISPLACEMENT == 10
    g = torch.empty(1, 1, 5, 6, device="meta")
    with pytest.raises(ValueError, match=r"forward: the displacement must be at least 1, "
                                         r"got d=0"):
        cv_mod.cost_volume(f, f, 0)
    with pytest.raises(ValueError, match=r"backward: the displacement must be at least 1, "
                                         r"got d=0"):
        cv_mod.cost_volume_backward(f, f, g, 0)
    for d in (*range(1, 11), 11, 12, 16):
        g = torch.empty(1, (2 * d + 1) ** 2, 5, 6, device="meta")
        with pytest.raises(ValueError, match="unsupported devices"):
            cv_mod.cost_volume(f, f, d)
        with pytest.raises(ValueError, match="unsupported devices"):
            cv_mod.cost_volume_backward(f, f, g, d)


def test_bench_flownetc_measures_on_cpu_and_refuses_other_modes():
    from ocflow_torch import bench

    model, x = bench.make_flownetc_inputs(1, 64, 64, "cpu", seed=0)
    assert not model.training and x.shape == (1, 64, 64, 6)
    assert float(model.conv1[1].running_var.min()) >= 0.5  # seeded statistics
    res = bench.measure_forward(model, x, iters=1, warmup=0)
    assert res["ms_per_batch"] > 0 and res["pairs_per_sec"] > 0
    for flag in ("--q8", "--train"):
        with pytest.raises(ValueError, match="FlowNetCV"):
            bench.main(["--model", "flownetc", flag, "--device", "cpu"])
