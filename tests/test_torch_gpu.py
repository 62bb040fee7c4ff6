"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and skips without one (the decision is
taken inside the ``cuda_device`` fixture). The file imports no JAX, so it
also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Tolerances, relative to max |plain|: fp32 1e-4 (summation order only);
bf16 2^-6, two bf16 ulps of the largest value (a rounding step of the
final or an intermediate store may differ). The int8 kernels are exact:
W8A8 codes and the bf16 outputs of int8-read convs equal their plain
version bit for bit, and so does the int8 GEMM probe. The training step's
bounds are stated at its test.
"""

import numpy as np
import pytest
import torch

from ocflow_torch.bench import smooth_images
from ocflow_torch.kernels import conv_chain, conv_chain_q8, cost_volume as cv_mod
from ocflow_torch.kernels import gemm as gemm_mod
from ocflow_torch.kernels.conv_chain import ConvSpec, conv_group, prepare_group
from ocflow_torch.kernels.conv_chain_q8 import prepare_group_q8, quantize_q8
from ocflow_torch.models import FlowNetCV, calibrate_q8, fast_apply, prepare
from ocflow_torch.train import create_train_state, make_unsupervised_flow_step

TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only on the GPU")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = tf32


def _close(got, ref, dtype):
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype] * ref.float().abs().max().item(), err


def _cases(rng):
    """(inputs, weights, biases, specs): reads out of order and across
    inputs and stripe blocks, every kernel tile width (cout 8..100), and a
    stride-2 conv on an odd-sized image chained into a dilated conv."""
    x = rng.normal(size=(2, 16, 9, 70))
    z = rng.normal(size=(2, 5, 9, 70))
    specs = [ConvSpec((1,), 24), ConvSpec((2, 0), 8, emit=True),
             ConvSpec((3, 1, 2), 40, act=False, emit=True),
             ConvSpec((2, 3, 4, 0), 100, emit=True)]
    cin = [5, 24 + 16, 8 + 5 + 24, 24 + 8 + 40 + 16]
    yield ([x, z], [rng.normal(size=(s.cout, c, 3, 3)) * 0.1
                    for s, c in zip(specs, cin)],
           [rng.normal(size=(s.cout,)) for s in specs], specs)
    specs = [ConvSpec((0,), 16, stride=2, emit=True),
             ConvSpec((1,), 16, dilation=3, emit=True)]
    yield ([rng.normal(size=(2, 3, 15, 33))],
           [rng.normal(size=(16, 3, 3, 3)) * 0.3,
            rng.normal(size=(16, 16, 3, 3)) * 0.1],
           [rng.normal(size=(16,)) for _ in specs], specs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cost_volume_kernel_matches_plain(cuda_device, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    f1, f2 = (torch.randn(2, 40, 13, 70, device=cuda_device, generator=gen)
              .to(dtype) for _ in range(2))
    got = cv_mod.cost_volume(f1, f2, 4)
    torch.cuda.synchronize()
    assert got.shape == (2, 81, 13, 70) and got.dtype == dtype
    _close(got, cv_mod.cost_volume_plain(f1, f2, 4), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_group_kernel_matches_plain(cuda_device, dtype):
    rng = np.random.default_rng(1)
    for inputs, weights, biases, specs in _cases(rng):
        t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
        grp = prepare_group([t(w) for w in weights], [t(b) for b in biases],
                            specs, len(inputs), dtype, cuda_device)
        xs = [t(x).to(cuda_device, dtype) for x in inputs]
        got = conv_group(xs, grp)
        ref = conv_chain.conv_group_plain(xs, grp)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            _close(g, r, dtype)


def test_fast_apply_on_gpu_goes_through_the_kernels(cuda_device):
    """fp32 fast_apply == eager FlowNetCV on the card (1e-4 of max |flow|),
    with one cost-volume launch per level and one conv launch per conv."""
    model = FlowNetCV(generator=torch.Generator().manual_seed(0)).to(cuda_device)
    x = torch.rand((2, 64, 128, 6), generator=torch.Generator().manual_seed(1))
    x = (x * 2 - 1).to(cuda_device)
    want_cg = sum(len(g.specs) for g in prepare(model, x.dtype, cuda_device).groups())
    cv_mod.cost_volume.launches = conv_chain.conv_group.launches = 0
    fast = fast_apply(model, x)
    torch.cuda.synchronize()
    assert (cv_mod.cost_volume.launches, conv_chain.conv_group.launches) == (5, want_cg)
    with torch.no_grad():
        ref = model(x)
    for f, r in zip(fast, ref):
        assert (f - r).abs().max().item() <= 1e-4 * r.abs().max().item()


def _q8_cases(rng):
    """(inputs, weights, biases, specs, in_scale, scales): int8 reads out of
    order across inputs and stripe blocks, q8 and bf16 outputs, every tile
    width, a conv reading the bf16 side stripe; then a stride-2 conv on an
    odd-sized image chained into a dilated one."""
    x = rng.normal(size=(2, 16, 9, 70))
    z = rng.normal(size=(2, 5, 9, 70))
    specs = [ConvSpec((1,), 24, q8=True), ConvSpec((2, 0), 8, emit=True),
             ConvSpec((3,), 40, act=False, emit=True),
             ConvSpec((2, 0, 1), 100, q8=True, emit=True)]
    cin = [5, 24 + 16, 8, 24 + 16 + 5]
    yield ([x, z], [rng.normal(size=(s.cout, c, 3, 3)) * 0.1
                    for s, c in zip(specs, cin)],
           [rng.normal(size=(s.cout,)) for s in specs], specs, 0.04,
           [0.05, None, None, 0.1])
    specs = [ConvSpec((0,), 16, stride=2, q8=True, emit=True),
             ConvSpec((1,), 16, dilation=3, q8=True, emit=True),
             ConvSpec((1, 2), 12, act=False, emit=True)]
    yield ([rng.uniform(-1, 1, size=(2, 3, 15, 33))],
           [rng.normal(size=(16, 3, 3, 3)) * 0.3,
            rng.normal(size=(16, 16, 3, 3)) * 0.1,
            rng.normal(size=(12, 32, 3, 3)) * 0.1],
           [rng.normal(size=(s.cout,)) * 0.1 for s in specs], specs, 1 / 127,
           [0.02, 0.02, None])


def test_conv_group_q8_kernel_matches_plain(cuda_device):
    """Codes and int8-read bf16 outputs equal; the bf16-read conv within
    2^-6 of max|plain|."""
    rng = np.random.default_rng(2)
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    for inputs, weights, biases, specs, s_in, scales in _q8_cases(rng):
        grp = prepare_group_q8([t(w) for w in weights], [t(b) for b in biases],
                               specs, [x.shape[1] for x in inputs], s_in,
                               scales, cuda_device)
        xs = [quantize_q8(t(x).to(cuda_device), s_in) for x in inputs]
        got = conv_chain_q8.conv_group_q8(xs, grp)
        ref = conv_chain_q8.conv_group_q8_plain(xs, grp)
        torch.cuda.synchronize()
        emitted = [j for j, s in enumerate(specs) if s.emit]
        for j, g, r in zip(emitted, got, ref):
            assert g.dtype == r.dtype
            if grp.int8_read[j]:
                assert torch.equal(g, r), (j, (g.float() - r.float()).abs().max())
            else:
                _close(g, r, torch.bfloat16)


def test_gemm_probe_matches_plain(cuda_device):
    gen = torch.Generator().manual_seed(3)
    a = torch.randint(-127, 128, (512, 512), generator=gen, dtype=torch.int8)
    b = torch.randint(-127, 128, (512, 512), generator=gen, dtype=torch.int8)
    a, b = a.to(cuda_device), b.to(cuda_device)
    got = gemm_mod.gemm(a, b)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, gemm_mod.gemm_plain(a, b))
    af, bf = (torch.randn(512, 512, generator=gen).bfloat16().to(cuda_device)
              for _ in range(2))
    got, ref = gemm_mod.gemm(af, bf), gemm_mod.gemm_plain(af, bf)
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()


def test_fast_apply_q8_on_gpu_goes_through_the_kernels(cuda_device):
    """W8A8 fast_apply on the card: one int8 launch per int8-read conv, one
    bf16 launch per other conv, finite flows near the exact forward."""
    model = FlowNetCV(generator=torch.Generator().manual_seed(0)).to(cuda_device)
    x = torch.rand((2, 64, 128, 6), generator=torch.Generator().manual_seed(1))
    x = (x * 2 - 1).to(cuda_device)
    scales = calibrate_q8(model, x)
    want = prepare(model, x.dtype, cuda_device, scales).launch_counts()
    cv_mod.cost_volume.launches = conv_chain.conv_group.launches = 0
    conv_chain_q8.conv_group_q8.launches = 0
    fast = fast_apply(model, x, q8=scales)
    torch.cuda.synchronize()
    assert (cv_mod.cost_volume.launches, conv_chain.conv_group.launches,
            conv_chain_q8.conv_group_q8.launches) == (
                5, want["conv_group"], want["conv_group_q8"]) == (5, 24, 35)
    with torch.no_grad():
        ref = model(x)
    for f, r in zip(fast, ref):
        assert torch.isfinite(f).all()
        assert (f - r).abs().max().item() <= 0.15 * r.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cost_volume_backward_kernel_matches_plain(cuda_device, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    f1, f2 = (torch.randn(2, 40, 13, 70, device=cuda_device, generator=gen)
              .to(dtype) for _ in range(2))
    g = torch.randn(2, 81, 13, 70, device=cuda_device, generator=gen).to(dtype)
    got = cv_mod.cost_volume_backward(f1, f2, g, 4)
    torch.cuda.synchronize()
    for a, b in zip(got, cv_mod.cost_volume_backward_plain(f1, f2, g, 4)):
        assert a.shape == f1.shape and a.dtype == dtype
        _close(a, b, dtype)


def test_conv_group_diff_grads_on_gpu(cuda_device):
    """Gradients of conv_group_diff (kernel forward, cuDNN VJPs) == autograd
    of the eager chain, fp32 with TF32 off, 1e-4 of max|grad|."""
    rng = np.random.default_rng(5)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda_device)  # noqa: E731
    specs = [ConvSpec((0,), 24), ConvSpec((0, 1), 16, dilation=2),
             ConvSpec((2, 0), 2, act=False)]
    raw = [rng.normal(size=(2, 16, 9, 70)), rng.normal(size=(24, 16, 3, 3)) * 0.1,
           rng.normal(size=(16, 40, 3, 3)) * 0.1, rng.normal(size=(2, 32, 3, 3)) * 0.1,
           rng.normal(size=(24,)), rng.normal(size=(16,)), rng.normal(size=(2,))]
    seeds = [t(rng.normal(size=(2, c, 9, 70))) for c in (24, 16, 2)]

    def grads(run):
        leaves = [t(a).requires_grad_() for a in raw]
        outs = run(leaves[0], leaves[1:4], leaves[4:])
        torch.autograd.backward(outs, seeds)
        return [x.grad for x in leaves]

    def eager(x, ws, bs):
        blocks = [x]
        for s, w, b in zip(specs, ws, bs):
            y = torch.nn.functional.conv2d(torch.cat([blocks[r] for r in s.reads], 1), w, b,
                                           padding=s.dilation, dilation=s.dilation)
            blocks.append(torch.nn.functional.leaky_relu(y, 0.1) if s.act else y)
        return blocks[1:]

    conv_chain.conv_group_diff.launches = 0
    got = grads(lambda x, ws, bs: conv_chain.conv_group_diff([x], ws, bs, specs))
    assert conv_chain.conv_group_diff.launches == len(specs)
    for a, b in zip(got, grads(eager)):
        _close(a, b, torch.float32)


def test_train_step_on_gpu_goes_through_the_kernels(cuda_device):
    """One bf16 step of the occlusion-aware fused path at 2x64x128 launches
    10 cost volumes, 5 backward, 31 conv_group_diff and 72 conv launches in
    all, and stays near the plain path, the eager fp32 step: loss within
    1e-2 relative, whole-gradient relative L2 within 0.2 (bf16 rounding of
    a random-weight net; the 448x1024 step measures 0.12). The fp32 fused
    step is within 1e-4 (metrics) and 1e-2 (whole-gradient relative L2) of
    the eager one."""
    gen = torch.Generator().manual_seed(0)
    base = FlowNetCV(generator=gen)
    coarse = torch.rand((2, 6, 8, 16), generator=gen) * 2 - 1
    batch = {"images": smooth_images(coarse).to(cuda_device)}
    hp = {"model": "pwc", "occ_aware": True, "occ_method": "range_map",
          "photo_weight": 4.0, "smooth1_weight": 0.5, "smooth2_weight": 0.0,
          "fast_forward": "both", "compute_dtype": "bfloat16"}

    def step(**kw):
        model = FlowNetCV()
        model.load_state_dict(base.state_dict())
        state = create_train_state(model, 1e-4, device=cuda_device)
        run, _ = make_unsupervised_flow_step({**hp, **kw})
        metrics = run(state, batch)[1]
        grad = torch.cat([p.grad.float().flatten() for p in model.parameters()])
        return {k: float(v) for k, v in metrics.items()}, grad

    counters = (cv_mod.cost_volume, cv_mod.cost_volume_backward, conv_chain.conv_group,
                conv_chain.conv_group_diff)
    for c in counters:
        c.launches = 0
    m16, g16 = step()
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [10, 5, 72, 31]
    m32, g32 = step(compute_dtype="float32")
    me, ge = step(compute_dtype="float32", fast_forward="off")
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
    for k in me:
        assert abs(m32[k] - me[k]) <= 1e-4 * abs(me[k]), k
    assert rel(g32, ge) <= 1e-2
    assert abs(m16["loss"] - me["loss"]) <= 1e-2 * me["loss"]
    assert rel(g16, ge) <= 0.2
