"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and skips without one (the decision is
taken inside the ``cuda_device`` fixture). The file imports no JAX, so it
also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Tolerances, relative to max |plain|: fp32 1e-4 (summation order only);
bf16 2^-6, two bf16 ulps of the largest value (a rounding step of the
final or an intermediate store may differ).
"""

import numpy as np
import pytest
import torch

from ocflow_torch.kernels import conv_chain, cost_volume as cv_mod
from ocflow_torch.kernels.conv_chain import ConvSpec, conv_group, prepare_group
from ocflow_torch.models import FlowNetCV, fast_apply, prepare

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
