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

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from ocflow_torch.bench import smooth_images
from ocflow_torch.kernels import conv_chain, conv_chain_q8, cost_volume as cv_mod
from ocflow_torch.kernels import gemm as gemm_mod
from ocflow_torch.kernels.conv_chain import ConvSpec, conv_group, prepare_group
from ocflow_torch.kernels.conv_chain_q8 import prepare_group_q8, quantize_q8
from ocflow_torch.models import (FlowNetC, FlowNetCV, FlowOccNetC, FlowOccNetCV,
                                 OcclusionNetC, calibrate_q8, fast_apply, prepare)
from ocflow_torch.models import flow_occ_nets as fon
from ocflow_torch.models.common import BatchNorm
from ocflow_torch.models import flow_net_s as fns
from ocflow_torch.models import pwc_fast
from ocflow_torch.models import pwc_net
from ocflow_torch.train import (create_train_state, make_supervised_flow_occ_step,
                                make_unsupervised_flow_step)

TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only on the GPU")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = tf32


@contextlib.contextmanager
def _plain_cost_volume():
    """The eager FlowNetCV on the plain cost volume (a reference that does
    not run the kernel under test)."""
    saved, pwc_net.cost_volume = pwc_net.cost_volume, cv_mod.cost_volume_plain
    try:
        yield
    finally:
        pwc_net.cost_volume = saved


def _close(got, ref, dtype):
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL[dtype] * ref.float().abs().max().item(), err


def mixed_case(rng):
    """(inputs, weights, biases, specs): reads out of order and across
    inputs and stripe blocks, every kernel tile width (cout 8..100), at
    9x70 (the staged kernel's 2-byte staging: 70 is not a multiple of 8)."""
    x = rng.normal(size=(2, 16, 9, 70))
    z = rng.normal(size=(2, 5, 9, 70))
    specs = [ConvSpec((1,), 24), ConvSpec((2, 0), 8, emit=True),
             ConvSpec((3, 1, 2), 40, act=False, emit=True),
             ConvSpec((2, 3, 4, 0), 100, emit=True)]
    cin = [5, 24 + 16, 8 + 5 + 24, 24 + 8 + 40 + 16]
    return ([x, z], [rng.normal(size=(s.cout, c, 3, 3)) * 0.1
                     for s, c in zip(specs, cin)],
            [rng.normal(size=(s.cout,)) for s in specs], specs)


def decoder_like_case(rng, h, w, c0=81):
    """A decoder's inputs (a ``c0``-channel cost volume, 1-, 2- and
    2-channel blocks) read whole (Cin not a multiple of 32, so the staged
    kernel's channel chunks span the 1-, 2- and 81-channel segments), cout
    128, 196, 2 and 8; the last conv reads eight segments out of order."""
    ins = [rng.normal(size=(2, c, h, w)) for c in (c0, 1, 2, 2)]
    specs = [ConvSpec((0, 1, 2, 3), 128), ConvSpec((0, 1, 2, 3, 4), 196),
             ConvSpec((4, 5), 2, act=False, emit=True),
             ConvSpec((6, 0, 5, 1, 4, 2, 3, 6), 8, emit=True)]
    ch = [c0, 1, 2, 2, 128, 196, 2]
    cin = [sum(ch[r] for r in s.reads) for s in specs]
    return (ins, [rng.normal(size=(s.cout, c, 3, 3)) * 0.1
                  for s, c in zip(specs, cin)],
            [rng.normal(size=(s.cout,)) for s in specs], specs)


def _cases(rng):
    """The mixed case; decoder-like chains at 7x16 (fewer rows than the
    staged tile's 8), 5x64 and 3x136 (a partial column tile), all three on
    the 16-byte staging; a stride-2 conv on an odd-sized image chained
    into a dilated conv (the gather kernel)."""
    yield mixed_case(rng)
    for h, w in ((7, 16), (5, 64), (3, 136)):
        yield decoder_like_case(rng, h, w)
    specs = [ConvSpec((0,), 16, stride=2, emit=True),
             ConvSpec((1,), 16, dilation=3, emit=True)]
    yield ([rng.normal(size=(2, 3, 15, 33))],
           [rng.normal(size=(16, 3, 3, 3)) * 0.3,
            rng.normal(size=(16, 16, 3, 3)) * 0.1],
           [rng.normal(size=(16,)) for _ in specs], specs)


# the five FlowNetCV pyramid levels at B=8 448x1024 (L6..L2)
FLOWNETCV_LEVELS = [(8, 196, 7, 16), (8, 128, 14, 32), (8, 96, 28, 64),
                    (8, 64, 56, 128), (8, 32, 112, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 40, 13, 70), *FLOWNETCV_LEVELS])
def test_cost_volume_kernel_matches_plain(cuda_device, shape, dtype):
    """The d=4 kernel: a ragged shape (W not a multiple of 16 bytes, so the
    staging reads one element at a time; C not a multiple of the chunk)
    and the five FlowNetCV levels."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    f1, f2 = (torch.randn(*shape, device=cuda_device, generator=gen)
              .to(dtype) for _ in range(2))
    got = cv_mod.cost_volume(f1, f2, 4)
    torch.cuda.synchronize()
    b, _, h, w = shape
    assert got.shape == (b, 81, h, w) and got.dtype == dtype
    _close(got, cv_mod.cost_volume_plain(f1, f2, 4), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 8, 9, 70), (2, 20, 33, 40), (8, 256, 56, 128)])
def test_cost_volume_d10_kernel_matches_plain(cuda_device, shape, dtype):
    """The d=10 kernel (441 shifts): H under 2d+1 (most shifts read the
    zero padding), W not a multiple of 32, C not a multiple of its 8-channel
    chunk, and the FlowNetC family's serving shape."""
    gen = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    f1, f2 = (torch.randn(*shape, device=cuda_device, generator=gen).to(dtype)
              for _ in range(2))
    got = cv_mod.cost_volume(f1, f2, 10)
    torch.cuda.synchronize()
    b, _, h, w = shape
    assert got.shape == (b, 441, h, w) and got.dtype == dtype
    _close(got, cv_mod.cost_volume_plain(f1, f2, 10), dtype)


def test_cost_volume_kernel_rejects_other_displacements(cuda_device):
    """d = 7 runs on the tuned kernels (C2) and d = 11 on the general ones
    (C3); d = 0 raises, naming the lower limit."""
    f = torch.randn(1, 8, 9, 70, device=cuda_device)
    g = torch.randn(1, 1, 9, 70, device=cuda_device)
    with pytest.raises(ValueError, match=r"at least 1, got d=0"):
        cv_mod.cost_volume(f, f, 0)
    with pytest.raises(ValueError, match=r"at least 1, got d=0"):
        cv_mod.cost_volume_backward(f, f, g, 0)
    for d in (7, 11):
        g = torch.randn(1, (2 * d + 1) ** 2, 9, 70, device=cuda_device)
        _close(cv_mod.cost_volume(f, f, d), cv_mod.cost_volume_plain(f, f, d), torch.float32)
        for got, ref in zip(cv_mod.cost_volume_backward(f, f, g, d),
                            cv_mod.cost_volume_backward_plain(f, f, g, d)):
            _close(got, ref, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 2, 3, 5, 6, 7, 8, 9])
def test_cost_volume_kernels_at_every_displacement_match_plain(cuda_device, d, dtype):
    """C2: the forward and backward kernels at every d but the tuned 4 and
    10 (those have their own tests), at a FlowNetCV level-2 width with H
    under 2d+1 rows and W not a multiple of the 32-column strip."""
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    shape = (2, 40, 13, 70)
    f1, f2 = (torch.randn(*shape, device=cuda_device, generator=gen).to(dtype)
              for _ in range(2))
    g = torch.randn(2, (2 * d + 1) ** 2, 13, 70, device=cuda_device, generator=gen).to(dtype)
    _close(cv_mod.cost_volume(f1, f2, d), cv_mod.cost_volume_plain(f1, f2, d), dtype)
    for got, ref in zip(cv_mod.cost_volume_backward(f1, f2, g, d),
                        cv_mod.cost_volume_backward_plain(f1, f2, g, d)):
        _close(got, ref, dtype)


@pytest.mark.parametrize("cls", [FlowNetC, OcclusionNetC, FlowOccNetC])
def test_flownetc_family_forward_on_gpu_launches_the_cost_volume_once(cuda_device, cls):
    """One eval forward at 2x128x128 fp32: one d=10 cost-volume launch, no
    other kernel; within 1e-4 of max|output| of the same forward with the
    plain cost volume."""
    model = cls(generator=torch.Generator().manual_seed(0)).eval().to(cuda_device)
    x = torch.rand((2, 128, 128, 6), generator=torch.Generator().manual_seed(1))
    x = (x * 2 - 1).to(cuda_device)
    counters = (cv_mod.cost_volume, cv_mod.cost_volume_backward, conv_chain.conv_group,
                conv_chain.conv_group_diff, conv_chain_q8.conv_group_q8)
    for c in counters:
        c.launches = 0
    with torch.no_grad():
        got = model(x)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [1, 0, 0, 0, 0]
    saved = fns.cost_volume
    fns.cost_volume = cv_mod.cost_volume_plain
    try:
        with torch.no_grad():
            ref = model(x)
    finally:
        fns.cost_volume = saved
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        assert (g - r).abs().max().item() <= 1e-4 * r.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_group_kernel_matches_plain(cuda_device, dtype):
    rng = np.random.default_rng(1)
    for inputs, weights, biases, specs in _cases(rng):
        t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
        grp = prepare_group([t(w) for w in weights], [t(b) for b in biases],
                            specs, len(inputs), dtype, cuda_device)
        xs = [t(x).to(cuda_device, dtype) for x in inputs]
        conv_group.staged_launches = 0
        got = conv_group(xs, grp)
        ref = conv_chain.conv_group_plain(xs, grp)
        torch.cuda.synchronize()
        assert conv_group.staged_launches == sum(
            conv_chain.is_staged(dtype, s) for s in specs)
        for g, r in zip(got, ref):
            _close(g, r, dtype)


def _tma_cases(rng):
    """Shapes the TMA kernel takes (rows of 16-byte multiples): the mixed
    case cut to 9x64, decoder-like chains at 9x72 (edge tiles both ways,
    C = 64), 14x32 (C = 32) and 7x16 (C = 16), a 2-channel-input conv at
    5x8 and at 32x512."""
    ins, ws, bs, specs = mixed_case(rng)
    yield [x[..., :64] for x in ins], ws, bs, specs
    for h, w in ((9, 72), (14, 32), (7, 16)):
        yield decoder_like_case(rng, h, w)
    for h, w in ((5, 8), (32, 512)):
        yield ([rng.normal(size=(2, 2, h, w))], [rng.normal(size=(8, 2, 3, 3)) * 0.3],
               [rng.normal(size=(8,))], [ConvSpec((0,), 8, act=False, emit=True)])


@pytest.mark.parametrize("split", [None, 1, 3, 16])
def test_conv_group_tma_kernel_matches_plain(cuda_device, split, monkeypatch):
    """Every conv of each case, every block emitted, within 2^-6 of its
    max|plain|, with the router's split K and with it forced (at most the
    conv's K chunks); ``conv_group.tma_launches`` counts the convs ``is_tma``
    gives the kernel, and ``staged=True`` keeps them all on the staged
    kernel."""
    if split is not None:
        monkeypatch.setattr(conv_chain, "tma_split",
                            lambda b, h, w, cout, nchunk: min(split, nchunk))
    rng = np.random.default_rng(4)
    for inputs, weights, biases, specs in _tma_cases(rng):
        specs = [dataclasses.replace(s, emit=True) for s in specs]
        t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
        grp = prepare_group([t(w) for w in weights], [t(b) for b in biases],
                            specs, len(inputs), torch.bfloat16, cuda_device)
        xs = [t(x).to(cuda_device, torch.bfloat16) for x in inputs]
        ho, wo = xs[0].shape[2:]
        want = sum(conv_chain.is_tma(torch.bfloat16, s, (ho, wo)) for s in specs)
        ref = conv_chain.conv_group_plain(xs, grp)
        for staged in (False, True):
            conv_group.tma_launches = conv_group.staged_launches = 0
            got = conv_group(xs, grp, staged=staged)
            torch.cuda.synchronize()
            assert conv_group.tma_launches == (0 if staged else want)
            assert conv_group.staged_launches == sum(
                conv_chain.is_staged(torch.bfloat16, s) for s in specs)
            for g, r in zip(got, ref, strict=True):
                _close(g, r, torch.bfloat16)


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
    with torch.no_grad(), _plain_cost_volume():
        ref = model(x)
    for f, r in zip(fast, ref):
        assert (f - r).abs().max().item() <= 1e-4 * r.abs().max().item()


def mixed_q8_case(rng):
    """(inputs, weights, biases, specs, in_scale, scales): int8 reads out of
    order across inputs and stripe blocks, q8 and bf16 outputs, every tile
    width, a conv reading the bf16 side stripe, at 9x70 (the staged int8
    kernel's byte staging: 70 is not a multiple of 16)."""
    x = rng.normal(size=(2, 16, 9, 70))
    z = rng.normal(size=(2, 5, 9, 70))
    specs = [ConvSpec((1,), 24, q8=True), ConvSpec((2, 0), 8, emit=True),
             ConvSpec((3,), 40, act=False, emit=True),
             ConvSpec((2, 0, 1), 100, q8=True, emit=True)]
    cin = [5, 24 + 16, 8, 24 + 16 + 5]
    return ([x, z], [rng.normal(size=(s.cout, c, 3, 3)) * 0.1
                     for s, c in zip(specs, cin)],
            [rng.normal(size=(s.cout,)) for s in specs], specs, 0.04,
            [0.05, None, None, 0.1])


def decoder_like_q8_case(rng, h, w, c0=81):
    """A W8A8 decoder's int8 inputs (a ``c0``-channel cost volume, 1-, 2-
    and 2-channel blocks) read whole (Cin not a multiple of 32, so the
    staged kernel's channel chunks span segments): two growth-like q8 convs
    (cout 128, 96), a bf16 flow head (cout 2), a bf16 conv reading eight
    int8 segments out of order (cout 8) and a conv reading the head from
    the bf16 side stripe (the bf16 kernel)."""
    ins = [rng.normal(size=(2, c, h, w)) for c in (c0, 1, 2, 2)]
    specs = [ConvSpec((0, 1, 2, 3), 128, q8=True),
             ConvSpec((0, 1, 2, 3, 4), 96, q8=True, emit=True),
             ConvSpec((4, 5), 2, act=False, emit=True),
             ConvSpec((5, 0, 4, 1, 3, 2, 5, 4), 8, emit=True),
             ConvSpec((6,), 8, act=False, emit=True)]
    ch = [c0, 1, 2, 2, 128, 96, 2]
    cin = [sum(ch[r] for r in s.reads) for s in specs]
    return (ins, [rng.normal(size=(s.cout, c, 3, 3)) * 0.1
                  for s, c in zip(specs, cin)],
            [rng.normal(size=(s.cout,)) * 0.1 for s in specs], specs, 3 / 127,
            [8 / 127, 8 / 127, None, None, None])


def test_fp32_fast_apply_holds_with_default_tf32_flags(cuda_device):
    """With cuDNN's TF32 flag on, as PyTorch sets it by default, fp32
    fast_apply at 2x448x1024 stays within 1e-4 of max|flow| of the eager
    fp32 forward run with TF32 off (its cuDNN convolutions are pinned to
    fp32; unpinned it measured 1.06e-4 at B=8), and hands the flag back."""
    model = FlowNetCV(generator=torch.Generator().manual_seed(0)).to(cuda_device)
    x = torch.rand((2, 448, 1024, 6), generator=torch.Generator().manual_seed(1))
    x = (x * 2 - 1).to(cuda_device)
    with torch.no_grad(), _plain_cost_volume():
        ref = model(x)
    torch.backends.cudnn.allow_tf32 = True
    try:
        fast = fast_apply(model, x)
        torch.cuda.synchronize()
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
    for f, r in zip(fast, ref):
        assert (f - r).abs().max().item() <= 1e-4 * r.abs().max().item()


def _q8_cases(rng):
    """The mixed case; decoder-like chains at 7x16 (fewer rows than the
    staged tile's 8), 5x64 and 3x136 (a partial column tile), all three on
    the 16-byte staging; then a stride-2 conv on an odd-sized image chained
    into a dilated one (the gather kernel) and a stride-1 conv over both."""
    yield mixed_q8_case(rng)
    for h, w in ((7, 16), (5, 64), (3, 136)):
        yield decoder_like_q8_case(rng, h, w)
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
    2^-6 of max|plain|. Every int8-read conv runs the int8 TMA kernel in a
    channels-innermost group (``tma_launches``), ``conv_group_q8.cu``
    otherwise: its staged kernel at stride 1 and dilation 1
    (``staged_launches``)."""
    rng = np.random.default_rng(2)
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    for inputs, weights, biases, specs, s_in, scales in _q8_cases(rng):
        grp = prepare_group_q8([t(w) for w in weights], [t(b) for b in biases],
                               specs, [x.shape[1] for x in inputs], s_in,
                               scales, cuda_device)
        xs = [quantize_q8(t(x).to(cuda_device), s_in) for x in inputs]
        conv_chain_q8.conv_group_q8.staged_launches = 0
        conv_chain_q8.conv_group_q8.tma_launches = 0
        got = conv_chain_q8.conv_group_q8(xs, grp)
        ref = conv_chain_q8.conv_group_q8_plain(xs, grp)
        torch.cuda.synchronize()
        assert conv_chain_q8.conv_group_q8.staged_launches == (0 if grp.nhwc else sum(
            conv_chain_q8.is_staged_q8(s) for j, s in enumerate(specs)
            if grp.int8_read[j]))
        assert conv_chain_q8.conv_group_q8.tma_launches == grp.n_tma8
        emitted = [j for j, s in enumerate(specs) if s.emit]
        for j, g, r in zip(emitted, got, ref):
            assert g.dtype == r.dtype
            if grp.int8_read[j]:
                assert torch.equal(g, r), (j, (g.float() - r.float()).abs().max())
            else:
                _close(g, r, torch.bfloat16)


def flownet_decoder_q8_case(rng, h, w, level2=False):
    """A W8A8 FlowNetCV decoder at its channel widths (tests/
    test_torch_q8_tma.py): the 81-channel cost volume, 32 features, 2 + 2
    up-sampled channels; five growth convs (q8), the flow head (cout 2),
    then the two phase convs (cout 8; one reads the head from the bf16
    stripe) or, at level 2, context conv 1 (cout 128)."""
    in_ch, growth = (81, 32, 2, 2), (128, 128, 96, 64, 32)
    ins = [rng.normal(size=(2, c, h, w)) for c in in_ch]
    specs = [ConvSpec(tuple(range(4 + j)), g, q8=True) for j, g in enumerate(growth)]
    specs.append(ConvSpec(tuple(range(9)), 2, act=False, emit=True))
    if level2:
        specs.append(ConvSpec(tuple(range(9)), 128, emit=True))
    else:
        specs += [ConvSpec((9,), 8, act=False, emit=True),
                  ConvSpec(tuple(range(9)), 8, act=False, emit=True)]
    ch = [*in_ch, *growth, 2]
    cin = [sum(ch[r] for r in s.reads) for s in specs]
    return (ins, [rng.normal(size=(s.cout, c, 3, 3)) * (0.5 / np.sqrt(c))
                  for s, c in zip(specs, cin)],
            [rng.normal(size=(s.cout,)) * 0.1 for s in specs], specs, 3 / 127,
            [6 / 127] * 5 + [None] * (len(specs) - 5))


def _q8_tma_cases(rng):
    yield mixed_q8_case(rng)
    for h, w in ((7, 16), (5, 64), (3, 136)):
        yield decoder_like_q8_case(rng, h, w)
    # FlowNetCV's decoder levels at B=2 (rows and flat tiles, ragged edges;
    # every split the router picks), KITTI's 19- and 76-wide levels
    for h, w in ((7, 16), (14, 32), (28, 64), (56, 128), (5, 19), (20, 76)):
        yield flownet_decoder_q8_case(rng, h, w)
    yield flownet_decoder_q8_case(rng, 112, 256, level2=True)


@pytest.mark.parametrize("split", [None, 1, 3, 16])
def test_conv_group_q8_tma_kernel_matches_plain(cuda_device, split, monkeypatch):
    """Every block of each channels-innermost case equal to the plain
    version (codes and int8-read bf16 outputs bit for bit), with the
    router's split K and with it forced (at most the conv's K chunks), all
    int8-read convs on the TMA kernel; the inputs given as codes (copied
    into the stripe) and as values (quantized into it)."""
    if split is not None:
        monkeypatch.setattr(conv_chain_q8, "tma_q8_split",
                            lambda b, h, w, cout, nchunk: min(split, nchunk))
    rng = np.random.default_rng(5)
    t = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    for inputs, weights, biases, specs, s_in, scales in _q8_tma_cases(rng):
        specs = [dataclasses.replace(s, emit=True) for s in specs]
        grp = prepare_group_q8([t(w) for w in weights], [t(b) for b in biases],
                               specs, [x.shape[1] for x in inputs], s_in,
                               scales, cuda_device)
        assert grp.nhwc
        floats = [t(x).to(cuda_device) for x in inputs]
        xs = [quantize_q8(x, s_in) for x in floats]
        ref = conv_chain_q8.conv_group_q8_plain(xs, grp)
        for given in (xs, floats):
            conv_chain_q8.conv_group_q8.tma_launches = 0
            got = conv_chain_q8.conv_group_q8(given, grp)
            torch.cuda.synchronize()
            assert conv_chain_q8.conv_group_q8.tma_launches == grp.n_int8
            for j, g, r in zip(range(len(specs)), got, ref, strict=True):
                assert g.dtype == r.dtype
                if grp.int8_read[j]:
                    assert torch.equal(g, r), (j, tuple(xs[0].shape),
                                               (g.float() - r.float()).abs().max())
                else:
                    _close(g, r, torch.bfloat16)


def test_fast_apply_q8_replays_every_int8_call_bit_for_bit(cuda_device):
    """The W8A8 forward at 2x448x1024: its 35 int8 convs on the TMA kernel;
    every ``conv_group_q8`` call replayed with every block emitted equals
    the plain version bit for bit (the bf16-read conv within 2^-6); once the
    caching allocator hands the stripes back at the same addresses, a
    forward encodes no tensor map and reuses the split-K workspace."""
    model = FlowNetCV(generator=torch.Generator().manual_seed(0)).to(cuda_device)
    model = model.bfloat16()
    x = torch.rand((2, 448, 1024, 6), generator=torch.Generator().manual_seed(1))
    x = (x * 2 - 1).to(cuda_device, torch.bfloat16)
    scales = calibrate_q8(model, x)
    calls, saved = [], pwc_fast.conv_group_q8

    def rec(*args):
        calls.append(args)
        return saved(*args)

    rec.__dict__ = saved.__dict__
    pwc_fast.conv_group_q8 = rec
    try:
        conv_chain_q8.conv_group_q8.tma_launches = 0
        fast_apply(model, x, q8=scales)
        torch.cuda.synchronize()
    finally:
        pwc_fast.conv_group_q8 = saved
    assert conv_chain_q8.conv_group_q8.tma_launches == 35 and len(calls) == 5
    for inputs, group in calls:
        every = dataclasses.replace(group, specs=tuple(
            dataclasses.replace(s, emit=True) for s in group.specs))
        got = conv_chain_q8.conv_group_q8(inputs, every)
        ref = conv_chain_q8.conv_group_q8_plain(inputs, every)
        torch.cuda.synchronize()
        for j, g, r in zip(range(len(every.specs)), got, ref, strict=True):
            if group.int8_read[j]:
                assert torch.equal(g, r), (tuple(inputs[0].shape), j)
            else:
                _close(g, r, torch.bfloat16)
    fast_apply(model, x, q8=scales)  # the caching allocator's steady state
    torch.cuda.synchronize()
    encodes = conv_chain_q8.tma_map_encodes()
    spaces = {k: v.data_ptr() for k, v in conv_chain_q8._WORKSPACE.items()}
    assert spaces
    fast_apply(model, x, q8=scales)
    torch.cuda.synchronize()
    assert conv_chain_q8.tma_map_encodes() == encodes
    assert {k: v.data_ptr() for k, v in conv_chain_q8._WORKSPACE.items()} == spaces


# (M, N, K) per dtype, on each one's tile grid (kernels.gemm.TILE: int8
# 256 x 128, bf16 128 x 256, K in blocks of 128 bytes; a ring of 4 stages)
GEMM_SHAPES = {
    "2048^3": {torch.int8: (2048, 2048, 2048), torch.bfloat16: (2048, 2048, 2048)},
    "one K block": {torch.int8: (256, 128, 128), torch.bfloat16: (128, 256, 64)},
    "5 K blocks, not a multiple of the stages": {torch.int8: (512, 256, 640),
                                                  torch.bfloat16: (256, 512, 320)},
    "153 tiles on 132 SMs, 7 K blocks": {torch.int8: (2304, 2176, 896),
                                         torch.bfloat16: (2176, 2304, 448)},
    "M, N, K all different": {torch.int8: (768, 384, 1152), torch.bfloat16: (384, 768, 1152)},
}


@pytest.mark.parametrize("case", list(GEMM_SHAPES))
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_gemm_probe_matches_plain(cuda_device, dtype, case):
    """The GEMM probe's kernel: int8 -> int32 equal to the exact product bit
    for bit, bf16 -> fp32 within 1e-2 of max|plain|. The cases drive the
    ring's phases through K counts that are not a multiple of its stages,
    a persistent block through more than one tile, and a shape whose three
    sizes differ."""
    m, n, k = GEMM_SHAPES[case][dtype]
    gen = torch.Generator().manual_seed(3)
    if dtype == torch.int8:
        a, b = (torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)
                for shape in ((m, k), (k, n)))
    else:
        a, b = (torch.randn(shape, generator=gen).bfloat16() for shape in ((m, k), (k, n)))
    a, b = a.to(cuda_device), b.to(cuda_device)
    before = gemm_mod.gemm.launches
    got = gemm_mod.gemm(a, b)
    torch.cuda.synchronize()
    ref = gemm_mod.gemm_plain(a, b)
    assert gemm_mod.gemm.launches == before + 1 and got.shape == (m, n)
    if dtype == torch.int8:
        assert got.dtype == torch.int32 and torch.equal(got, ref)
    else:
        assert got.dtype == torch.float32
        assert (got - ref).abs().max().item() <= 1e-2 * ref.abs().max().item()


def test_fast_apply_q8_on_gpu_goes_through_the_kernels(cuda_device):
    """W8A8 fast_apply on the card: one int8 launch per int8-read conv (all
    35 of stride 1, all 35 on the TMA kernel, none on conv_group_q8.cu),
    one bf16 launch per other conv, finite flows near the exact forward."""
    model = FlowNetCV(generator=torch.Generator().manual_seed(0)).to(cuda_device)
    x = torch.rand((2, 64, 128, 6), generator=torch.Generator().manual_seed(1))
    x = (x * 2 - 1).to(cuda_device)
    scales = calibrate_q8(model, x)
    want = prepare(model, x.dtype, cuda_device, scales).launch_counts()
    cv_mod.cost_volume.launches = conv_chain.conv_group.launches = 0
    conv_chain_q8.conv_group_q8.launches = conv_chain_q8.conv_group_q8.staged_launches = 0
    conv_chain_q8.conv_group_q8.tma_launches = 0
    fast = fast_apply(model, x, q8=scales)
    torch.cuda.synchronize()
    assert (cv_mod.cost_volume.launches, conv_chain.conv_group.launches,
            conv_chain_q8.conv_group_q8.launches,
            conv_chain_q8.conv_group_q8.staged_launches,
            conv_chain_q8.conv_group_q8.tma_launches) == (
                5, want["conv_group"], want["conv_group_q8"],
                want["conv_group_q8_staged"], want["conv_group_q8_tma"]) == (5, 24, 0, 0, 35)
    with torch.no_grad():
        ref = model(x)
    for f, r in zip(fast, ref):
        assert torch.isfinite(f).all()
        assert (f - r).abs().max().item() <= 0.15 * r.abs().max().item()


def _cv_backward_inputs(device, shape, d, dtype, seed=4):
    gen = torch.Generator(device=device).manual_seed(seed)
    f1, f2 = (torch.randn(*shape, device=device, generator=gen).to(dtype)
              for _ in range(2))
    b, _, h, w = shape
    g = torch.randn(b, (2 * d + 1) ** 2, h, w, device=device, generator=gen).to(dtype)
    return f1, f2, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 40, 13, 70), (1, 8, 9, 70), (2, 20, 33, 40),
                                   (8, 256, 56, 128)])
@pytest.mark.parametrize("d", [4, 10])
def test_cost_volume_backward_kernel_matches_plain(cuda_device, d, shape, dtype):
    """Both displacements: H under 2d+1 (9 rows), W not a multiple of the
    32-column strip or of 16 bytes (70), C not a multiple of the 32-channel
    group (40, 20, 8), and the FlowNetC family's shape."""
    f1, f2, g = _cv_backward_inputs(cuda_device, shape, d, dtype)
    got = cv_mod.cost_volume_backward(f1, f2, g, d)
    torch.cuda.synchronize()
    for a, b in zip(got, cv_mod.cost_volume_backward_plain(f1, f2, g, d)):
        assert a.shape == f1.shape and a.dtype == dtype
        _close(a, b, dtype)


@pytest.mark.parametrize("d", [4, 10])
def test_cost_volume_backward_kernel_is_deterministic(cuda_device, d):
    """Gather form, no atomics: two calls give the same bits."""
    f1, f2, g = _cv_backward_inputs(cuda_device, (2, 40, 13, 70), d, torch.float32)
    first = cv_mod.cost_volume_backward(f1, f2, g, d)
    second = cv_mod.cost_volume_backward(f1, f2, g, d)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


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


def _bf16_group(rng, b, h, w, dev):
    """A decoder-shaped bf16 group: four inputs (17, 8, 2, 2 channels),
    growth (16, 16, 8, 8, 4), a 2-channel head without LeakyReLU, one conv
    over the inputs and the growth blocks; weights at the init's scale."""
    in_ch, growth = (17, 8, 2, 2), (16, 16, 8, 8, 4)
    n_in = len(in_ch)
    specs = ([ConvSpec(tuple(range(n_in + j)), g) for j, g in enumerate(growth)]
             + [ConvSpec(tuple(range(n_in + 5)), 2, act=False),
                ConvSpec(tuple(range(n_in + 5)), 8)])
    chans = [*in_ch, *(s.cout for s in specs)]
    t = lambda a: torch.tensor(a, dtype=torch.bfloat16, device=dev)  # noqa: E731
    xs = [t(rng.normal(size=(b, c, h, w))) for c in in_ch]
    ws = [t(rng.normal(size=(s.cout, sum(chans[r] for r in s.reads), 3, 3))
            / np.sqrt(9 * sum(chans[r] for r in s.reads))) for s in specs]
    bs = [t(rng.normal(size=(s.cout,)) * 0.1) for s in specs]
    seeds = [t(rng.normal(size=(b, s.cout, h, w))) for s in specs]
    return xs, ws, bs, specs, seeds


def _diff_grads(xs, ws, bs, specs, seeds, vjp=False):
    leaves = [a.clone().requires_grad_() for a in (*xs, *ws, *bs)]
    n_in, n = len(xs), len(specs)
    outs = conv_chain.conv_group_diff(leaves[:n_in], leaves[n_in:n_in + n],
                                      leaves[n_in + n:], specs, vjp=vjp)
    # the first growth block gets no cotangent of its own
    torch.autograd.backward(outs[1:], [g.to(o.device) for o, g in zip(outs[1:], seeds[1:])])
    return [a.grad for a in leaves]


def _zero_bwd_counters():
    for name in ("dx_launches", "dw_launches", "vjp_calls"):
        setattr(conv_chain.conv_group_diff, name, 0)


def test_conv_group_diff_backward_kernels_match_the_vjp_route(cuda_device):
    """A bf16 group the TMA kernel takes (W 40, a multiple of 8 but not of
    the kernels' 64-pixel lines) runs its backward on the two kernels: one
    dX launch per growth block and one for its inputs, one dW launch per
    conv, no cuDNN VJP; every gradient within 2^-6 of max|grad| of the VJP
    route's (which adds bf16 partial sums where the kernels sum in fp32)."""
    xs, ws, bs, specs, seeds = _bf16_group(np.random.default_rng(11), 2, 9, 40, cuda_device)
    _zero_bwd_counters()
    got = _diff_grads(xs, ws, bs, specs, seeds)
    torch.cuda.synchronize()
    f = conv_chain.conv_group_diff
    assert (f.dx_launches, f.dw_launches, f.vjp_calls) == (6, len(specs), 0)
    ref = _diff_grads(xs, ws, bs, specs, seeds, vjp=True)
    assert f.vjp_calls == sum(len(s.reads) for s in specs)
    for a, b in zip(got, ref):
        assert a.dtype == torch.bfloat16 and torch.isfinite(a).all()
        _close(a, b, torch.bfloat16)


def test_conv_group_diff_kitti_width_takes_the_vjp_route(cuda_device):
    """At width 76 (KITTI's 320x1216 level 2: rows not a multiple of 16
    bytes) the group's backward keeps the VJP route, counted there, and its
    gradients are the CPU chain's (the two kernels' plain versions) within
    2^-6 of max|grad|."""
    xs, ws, bs, specs, seeds = _bf16_group(np.random.default_rng(12), 2, 6, 76, cuda_device)
    _zero_bwd_counters()
    got = _diff_grads(xs, ws, bs, specs, seeds)
    torch.cuda.synchronize()
    f = conv_chain.conv_group_diff
    assert (f.dx_launches, f.dw_launches) == (0, 0)
    assert f.vjp_calls == sum(len(s.reads) for s in specs)
    cpu = [[a.cpu() for a in group] for group in (xs, ws, bs)]
    ref = _diff_grads(*cpu, specs, [g.cpu() for g in seeds])
    for a, b in zip(got, ref):
        _close(a.cpu(), b, torch.bfloat16)


def test_train_step_on_gpu_goes_through_the_kernels(cuda_device):
    """One bf16 step of the occlusion-aware fused path at 2x64x128 launches
    10 cost volumes, 5 backward, 31 conv_group_diff and 72 conv launches in
    all, the conv_group_diff backward 18 dX and 19 dW launches (levels 4-2;
    levels 6 and 5 are too narrow for the kernels and take the VJP route),
    and stays near the plain path, the eager fp32 step: loss within
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
    _zero_bwd_counters()
    m16, g16 = step()
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [10, 5, 72, 31]
    # the backward: levels 4-2 (8, 16, 32 wide) on the kernels (6 dX, 6 / 6 /
    # 7 dW), levels 6 and 5 (2 and 4 wide: rows under 16 bytes) on the VJP
    # route, one VJP per (conv, read block): 21 + 39
    f = conv_chain.conv_group_diff
    assert (f.dx_launches, f.dw_launches, f.vjp_calls) == (18, 19, 60)
    m32, g32 = step(compute_dtype="float32")
    with _plain_cost_volume():
        me, ge = step(compute_dtype="float32", fast_forward="off")
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
    for k in me:
        assert abs(m32[k] - me[k]) <= 1e-4 * abs(me[k]), k
    assert rel(g32, ge) <= 1e-2
    assert abs(m16["loss"] - me["loss"]) <= 1e-2 * me["loss"]
    assert rel(g16, ge) <= 0.2


@pytest.mark.parametrize("size,index", [((64, 128), 3), ((448, 1024), 0)])
def test_synthetic_flow_warp_on_the_card_matches_cpu(cuda_device, size, index):
    """The dataset generated on the card (cuDNN blur, gathers) against the
    same sample generated on the CPU: images within 1e-4 abs, flow within
    1e-4 px (summation order)."""
    from ocflow_torch.data import SyntheticFlowWarp

    got = SyntheticFlowWarp(size=8, image_size=size, device=cuda_device)[index]
    ref = SyntheticFlowWarp(size=8, image_size=size, device="cpu")[index]
    for k in ("images", "flow"):
        assert got[k].device.type == "cuda" and got[k].dtype == torch.float32
        assert (got[k].cpu() - ref[k]).abs().max().item() <= 1e-4, k


def test_device_cache_loader_serves_cuda_tensors(cuda_device):
    """The cache is resident on the card (bf16 images, fp32 flow) and every
    batch is an fp32 gather there, the ragged eval batch kept."""
    from ocflow_torch.data import DeviceCacheLoader, SyntheticFlowWarp

    ds = SyntheticFlowWarp(size=6, image_size=(64, 128), device=cuda_device)
    loader = DeviceCacheLoader(ds, batch_size=4, drop_last=False, num_workers=2,
                               device=cuda_device)
    cache = loader.cache()
    assert cache["images"].dtype == torch.bfloat16 and cache["flow"].dtype == torch.float32
    assert all(v.device.type == "cuda" for v in cache.values())
    batches = list(loader)
    assert [b["images"].shape[0] for b in batches] == [4, 2]
    for b in batches:
        assert all(v.device.type == "cuda" and v.dtype == torch.float32 for v in b.values())
    assert torch.equal(batches[1]["flow"][1], cache["flow"][5])
    assert torch.equal(batches[1]["images"][1], cache["images"][5].float())


def test_eager_flownetcv_on_gpu_runs_the_cost_volume_kernels(cuda_device):
    """The eager fp32 FlowNetCV at 2x128x256 launches the cost-volume
    kernel at each of its 5 levels, and its backward kernel 5 times under
    autograd; its flows are within 1e-4 of max|flow| of the same forward on
    the plain cost volume."""
    model = FlowNetCV(generator=torch.Generator().manual_seed(0)).to(cuda_device)
    x = torch.rand((2, 128, 256, 6), generator=torch.Generator().manual_seed(1))
    x = (x * 2 - 1).to(cuda_device)
    cv_mod.cost_volume.launches = cv_mod.cost_volume_backward.launches = 0
    with torch.no_grad():
        got = model(x)
    torch.cuda.synchronize()
    assert (cv_mod.cost_volume.launches, cv_mod.cost_volume_backward.launches) == (5, 0)
    with torch.no_grad(), _plain_cost_volume():
        ref = model(x)
    for g, r in zip(got, ref):
        assert (g - r).abs().max().item() <= 1e-4 * r.abs().max().item()
    cv_mod.cost_volume.launches = 0
    model(x)[0].square().mean().backward()
    torch.cuda.synchronize()
    assert (cv_mod.cost_volume.launches, cv_mod.cost_volume_backward.launches) == (5, 5)


@pytest.mark.parametrize("mode", ["fp32", "bf16", "w8a8"])
def test_fast_apply_at_kitti_shape_replays_against_plain(cuda_device, mode):
    """``fast_apply`` at 1x320x1216 (KITTI 375x1242 cropped; level 6 is 19
    wide, not a multiple of 4, 8 or 16: the cost volume's non-vector paths,
    the conv kernels' masked tile columns): every kernel call replayed
    against its plain version, fp32 within 1e-4 and bf16 within 2^-6 of
    max|plain|, int8 bit for bit."""
    dtype = torch.float32 if mode == "fp32" else torch.bfloat16
    model = FlowNetCV(generator=torch.Generator().manual_seed(0)).to(cuda_device, dtype)
    x = torch.rand((1, 320, 1216, 6), generator=torch.Generator().manual_seed(1))
    x = (x * 2 - 1).to(cuda_device, dtype)
    q8 = calibrate_q8(model, x) if mode == "w8a8" else None
    calls = []
    names = ("cost_volume", "conv_group", "conv_group_q8")
    saved = {n: getattr(pwc_fast, n) for n in names}

    def recorder(n):
        def rec(*args):
            calls.append((n, args))
            return saved[n](*args)
        rec.__dict__ = saved[n].__dict__
        return rec

    for n in names:
        setattr(pwc_fast, n, recorder(n))
    try:
        flow = fast_apply(model, x, q8=q8)[0]
    finally:
        for n in names:
            setattr(pwc_fast, n, saved[n])
    assert flow.shape == (1, 320, 1216, 2) and torch.isfinite(flow).all()
    assert {n for n, _ in calls} == ({"cost_volume", "conv_group", "conv_group_q8"}
                                     if q8 else {"cost_volume", "conv_group"})
    widths = set()
    for n, args in calls:
        if n == "cost_volume":
            widths.add(args[0].shape[-1])
            _close(cv_mod.cost_volume(*args), cv_mod.cost_volume_plain(*args), dtype)
        elif n == "conv_group":
            for g, r in zip(conv_group(*args), conv_chain.conv_group_plain(*args)):
                _close(g, r, dtype)
        else:
            # int8-read convs bit for bit; a bf16-read conv (the up-flow
            # phase conv) runs a bf16 kernel: within 2^-6
            group = args[1]
            emitted = [j for j, s in enumerate(group.specs) if s.emit]
            for j, g, r in zip(emitted, conv_chain_q8.conv_group_q8(*args),
                               conv_chain_q8.conv_group_q8_plain(*args), strict=True):
                if group.int8_read[j]:
                    assert torch.equal(g, r)
                else:
                    _close(g, r, torch.bfloat16)
    assert widths == {19, 38, 76, 152, 304}


class _PlainBackward(torch.autograd.Function):
    """The cost-volume kernel's forward with the plain backward."""

    @staticmethod
    def forward(ctx, f1, f2, d):
        ctx.save_for_backward(f1, f2)
        ctx.d = d
        return cv_mod.cost_volume(f1, f2, d)

    @staticmethod
    def backward(ctx, g):
        return (*cv_mod.cost_volume_backward_plain(*ctx.saved_tensors, g.contiguous(), ctx.d),
                None)


def test_supervised_pwoc_step_on_gpu_matches_the_plain_cost_volume(cuda_device):
    """One supervised flow+occlusion step of FlowOccNetCV (pwoc) at 2x128x256
    fp32, deterministic algorithms: 5 cost-volume and 5 backward launches,
    nothing else; the loss within 1e-5 relative of the same step on the
    plain cost volume, and each parameter's gradient within 1e-4 of its
    max|grad| of the same step with the plain backward on the kernel's
    forward (only the backward's summation order differs; with the plain
    forward too, its summation order flips LeakyReLU slopes)."""
    gen = torch.Generator().manual_seed(0)
    model = FlowOccNetCV(generator=gen)
    x = torch.rand((2, 128, 256, 6), generator=gen) * 2 - 1
    batch = {"images": x.to(cuda_device),
             "flow": (torch.randn((2, 128, 256, 2), generator=gen) * 3).to(cuda_device),
             "occ": (torch.rand((2, 128, 256, 1), generator=gen) > 0.8).float().to(cuda_device)}
    train_step, _ = make_supervised_flow_occ_step({"model": "pwoc"})
    states = {}
    det = (torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    counters = (cv_mod.cost_volume, cv_mod.cost_volume_backward, conv_chain.conv_group,
                conv_chain.conv_group_diff, conv_chain_q8.conv_group_q8)
    saved = fon.cost_volume
    try:
        for name, fn in (("kernel", saved), ("plain backward", _PlainBackward.apply),
                         ("plain", cv_mod.cost_volume_plain)):
            net = FlowOccNetCV()
            net.load_state_dict(model.state_dict())
            state = create_train_state(net, 1e-4, device=cuda_device)
            for c in counters:
                c.launches = 0
            fon.cost_volume = fn
            _, metrics = train_step(state, batch)
            torch.cuda.synchronize()
            states[name] = (state, metrics, [c.launches for c in counters])
    finally:
        fon.cost_volume = saved
        torch.backends.cudnn.deterministic = det[0]
        torch.use_deterministic_algorithms(det[1], warn_only=det[2])
    state, metrics, launches = states["kernel"]
    assert launches == [5, 5, 0, 0, 0]
    for k, v in states["plain"][1].items():
        assert abs(metrics[k].item() - v.item()) <= 1e-5 * abs(v.item()), k
    ref_grads = dict(states["plain backward"][0].model.named_parameters())
    for name, p in state.model.named_parameters():
        r = ref_grads[name].grad
        assert (p.grad - r).abs().max() <= 1e-4 * r.abs().max(), name


def test_flax_batchnorm_on_gpu_matches_the_cpu(cuda_device):
    """``models.common.BatchNorm`` in train mode on the card: the output and
    the updated running statistics (flax's biased-variance update) equal
    the CPU's within 1e-5."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((4, 16, 24, 40), generator=gen) * 2 + 0.5
    bns = [BatchNorm(16), BatchNorm(16).to(cuda_device)]
    for bn in bns:
        bn.weight.data.copy_(torch.linspace(0.5, 1.5, 16))
        bn.bias.data.copy_(torch.linspace(-0.1, 0.1, 16))
    outs = [bn.train()(x.to(bn.weight.device)) for bn in bns]
    assert (outs[1].cpu() - outs[0]).abs().max() <= 1e-5 * outs[0].abs().max()
    var = x.var(dim=(0, 2, 3), correction=0)
    torch.testing.assert_close(bns[0].running_var, 0.9 + 0.1 * var, rtol=1e-5, atol=1e-6)
    for name in ("running_mean", "running_var"):
        torch.testing.assert_close(getattr(bns[1], name).cpu(), getattr(bns[0], name),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("key,launches", [("flownetc", [2, 1]), ("flownet", [10, 5])])
def test_unsupervised_zoo_step_on_gpu_launches_the_cost_volume_without_tf32(
        cuda_device, monkeypatch, key, launches):
    """One occlusion-aware unsupervised step under ``compute_dtype:
    bfloat16`` (the loss tail's images only) at 2x64x128: FlowNetC's d=10
    cost volume runs twice (the forward and the backward-flow pass) and its
    backward once, FlowNet's d=4 ones at five levels 10 and 5 times, and no
    other kernel; every convolution of the step, forward and backward, runs
    with cuDNN's TF32 off though the caller's flag allows it."""
    from ocflow_torch.models import registry

    seen = []
    conv2d = torch.nn.functional.conv2d

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    gen = torch.Generator().manual_seed(0)
    model = registry.build("flow", key, generator=gen)
    first = next(m for m in model.modules() if isinstance(m, torch.nn.Conv2d))
    first.weight.register_hook(lambda g: seen.append(torch.backends.cudnn.allow_tf32))
    coarse = torch.rand((2, 6, 8, 16), generator=gen) * 2 - 1
    batch = {"images": smooth_images(coarse).to(cuda_device)}
    hp = {"model": key, "occ_aware": True, "occ_method": "range_map", "photo_weight": 4.0,
          "smooth1_weight": 0.5, "smooth2_weight": 0.0, "compute_dtype": "bfloat16"}
    state = create_train_state(model, 1e-4, device=cuda_device)
    train_step, _ = make_unsupervised_flow_step(hp)
    counters = (cv_mod.cost_volume, cv_mod.cost_volume_backward, conv_chain.conv_group,
                conv_chain.conv_group_diff, conv_chain_q8.conv_group_q8)
    for c in counters:
        c.launches = 0
    torch.backends.cudnn.allow_tf32 = True
    _, metrics = train_step(state, batch)
    torch.cuda.synchronize()
    assert torch.backends.cudnn.allow_tf32
    assert [c.launches for c in counters] == launches + [0, 0, 0]
    assert len(seen) > 20 and not any(seen)
    assert all(torch.isfinite(v).all() for v in metrics.values())


def _general_case(device, shape, d, dtype, seed):
    """One general-kernel forward and backward at ``shape`` against the
    plain versions; the general counters count those launches only."""
    gen = torch.Generator(device=device).manual_seed(seed)
    f1, f2 = (torch.randn(*shape, device=device, generator=gen).to(dtype) for _ in range(2))
    b, _, h, w = shape
    g = torch.randn(b, (2 * d + 1) ** 2, h, w, device=device, generator=gen).to(dtype)
    cv_mod.cost_volume.general_launches = cv_mod.cost_volume_backward.general_launches = 0
    _close(cv_mod.cost_volume(f1, f2, d), cv_mod.cost_volume_plain(f1, f2, d), dtype)
    for got, ref in zip(cv_mod.cost_volume_backward(f1, f2, g, d),
                        cv_mod.cost_volume_backward_plain(f1, f2, g, d)):
        _close(got, ref, dtype)
    cv_mod.cost_volume(f1, f2, 4)
    assert (cv_mod.cost_volume.general_launches,
            cv_mod.cost_volume_backward.general_launches) == (1, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [11, 12, 16, 20])
def test_cost_volume_general_kernels_match_plain(cuda_device, d, dtype):
    """Every d above 10 on ``csrc/cost_volume_any.cu``, forward and
    backward, at a map narrower and shorter than the shift window: W = 45
    (not a multiple of 4: the staging's element path) and W = 64 (its
    16-byte vector path), 20 channels (not a multiple of a chunk)."""
    for w in (45, 64):
        _general_case(cuda_device, (2, 20, 13, w), d, dtype, seed=d + w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cost_volume_general_kernels_have_no_limit_on_d(cuda_device, dtype):
    """d = 40 (6561 shifts) on a small map: the backward's ring is sized at
    launch, with no new limit on d."""
    _general_case(cuda_device, (1, 8, 5, 24), 40, dtype, seed=40)


def test_inpainting_train_step_on_gpu_runs_in_full_fp32(cuda_device, monkeypatch):
    """One supervised inpainting step at 2x64x128 on the card: both TF32
    flags read off inside the step though the caller's allow TF32, every
    kernel counter of the repository at 0, and the step equal to the same
    step on the CPU (loss 1e-5 relative, BatchNorm statistics 1e-5 of max)."""
    from ocflow_torch.models import InpaintingNet
    from ocflow_torch.train import make_supervised_inpainting_step

    seen = []
    conv2d = torch.nn.functional.conv2d

    def spy(*args, **kwargs):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    rng = np.random.default_rng(0)
    batch = {"images": torch.from_numpy(rng.uniform(-1, 1, (2, 64, 128, 6)).astype(np.float32)),
             "flow": torch.from_numpy((rng.normal(size=(2, 64, 128, 2)) * 3).astype(np.float32)),
             "occ": torch.from_numpy((rng.uniform(size=(2, 64, 128, 1)) > 0.7)
                                     .astype(np.float32))}
    train_step, _ = make_supervised_inpainting_step()
    out = {}
    for dev in ("cpu", cuda_device):
        model = InpaintingNet(generator=torch.Generator().manual_seed(0))
        state = create_train_state(model, 1e-4, device=dev)
        counters = (cv_mod.cost_volume, cv_mod.cost_volume_backward, conv_chain.conv_group,
                    conv_chain.conv_group_diff, conv_chain_q8.conv_group_q8)
        for c in counters:
            c.launches = 0
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        seen.clear()
        try:
            _, metrics = train_step(state, {k: v.to(dev) for k, v in batch.items()})
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        assert [c.launches for c in counters] == [0] * 5
        assert len(seen) > 20 and not any(a or b for a, b in seen)
        out[str(dev)] = (metrics["loss"].item(), {k: v.cpu() for k, v in
                                                  model.state_dict().items() if "running" in k})
    (loss_c, stats_c), (loss_g, stats_g) = out.values()
    assert abs(loss_g - loss_c) <= 1e-5 * abs(loss_c)
    for k, v in stats_c.items():
        assert (stats_g[k] - v).abs().max() <= 1e-5 * v.abs().max(), k


def test_evaluate_inpainting_on_gpu_matches_cpu(cuda_device, capsys):
    """``evaluate --task inpainting`` on the card, by default, against the
    same evaluation on the CPU (1e-5 relative)."""
    from ocflow_torch import evaluate as tevaluate

    args = ["--task", "inpainting", "--model", "simple", "--dataset", "SyntheticInpainting",
            "--dataset_size", "4", "--image_size", "64", "128", "--batch_size", "2"]
    on_card = tevaluate.main(args)
    on_cpu = tevaluate.main(args + ["--device", "cpu"])
    for k, v in on_cpu.items():
        assert abs(on_card[k] - v) <= 1e-5 * abs(v), (k, on_card[k], v)
    assert on_card["ssim"] <= 1.0


def test_evaluate_inpainting_memory_stays_flat(cuda_device, capsys):
    """ROADMAP C6: ``evaluate --task inpainting --with_fid --allow_random_fid``
    keeps its batches and FID's image stacks on the host, so the card's peak
    memory for 16 batches stays within a quarter of one batch's bytes
    (B=16 at 256x512: occluded, image and mask in fp32, 58.7 MB) of the peak
    for 4 batches. Holding every batch on the card, as before, added 12
    batches and their two image stacks. Both runs feed Inception whole
    chunks of 64 images, so its activations are the same."""
    import gc

    from ocflow_torch import evaluate as tevaluate

    batch, (h, w) = 16, (256, 512)
    peaks = {}
    for batches in (4, 16):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        tevaluate.main(["--task", "inpainting", "--model", "simple", "--dataset",
                        "SyntheticInpainting", "--dataset_size", str(batch * batches),
                        "--image_size", str(h), str(w), "--batch_size", str(batch),
                        "--with_fid", "--allow_random_fid"])
        torch.cuda.synchronize()
        peaks[batches] = torch.cuda.max_memory_allocated() - base
    batch_bytes = batch * h * w * 7 * 4
    print(f"peak device bytes above the start, 4 and 16 batches: {peaks}; one batch "
          f"{batch_bytes}")
    assert peaks[16] <= peaks[4] + batch_bytes / 4, (peaks, batch_bytes)


def test_attention_on_gpu_matches_cpu(cuda_device):
    """The blockwise attention (four KV blocks) and the dense one on the
    card, TF32 off for the matmuls, against the same calls on the CPU:
    outputs and the gradients of q, k and v within 1e-5 of max|.| (fp32
    summation order), and blockwise against dense on the card."""
    from ocflow_torch.ops import attention as att

    rng = np.random.default_rng(0)
    q, k = (rng.normal(size=(2, 4096, 16)).astype(np.float32) for _ in range(2))
    v, g = (rng.normal(size=(2, 4096, 128)).astype(np.float32) for _ in range(2))
    res = {}
    for dev in ("cpu", cuda_device):
        for name, fn in (("dense", att.dense_attention),
                         ("blockwise", lambda a, b, c: att.blockwise_attention(a, b, c, 1024))):
            ts = [torch.from_numpy(a).to(dev).requires_grad_() for a in (q, k, v)]
            torch.backends.cuda.matmul.allow_tf32 = False
            out = fn(*ts)
            out.backward(torch.from_numpy(g).to(dev))
            res[(str(dev), name)] = [t.detach().cpu() for t in (out, *(a.grad for a in ts))]
    for (a, b) in ((("cuda", "blockwise"), ("cpu", "blockwise")),
                   (("cuda", "dense"), ("cpu", "dense")),
                   (("cuda", "blockwise"), ("cuda", "dense"))):
        for got, want in zip(res[a], res[b]):
            assert (got - want).abs().max() <= 1e-5 * want.abs().max(), (a, b)


def test_gan_step_on_gpu_matches_cpu(cuda_device):
    """One GAN step (projected nets, seeded, ``gamma`` 0.5, 2x64x128, SGD)
    on the card against the CPU in fp64 (cuDNN's fp64 convolutions): every
    metric within 1e-9 relative, every gradient within 1e-9 of its tensor's
    max|grad| (tensors whose gradient is zero, within 1e-12 of the net's),
    G's statistics and D's ``u`` and ``sigma`` within 1e-9; in fp32 the
    losses within 1e-4 relative (printed). No kernel of the repository
    launches."""
    from ocflow_torch.models import InpaintSADiscriminator, InpaintSANet
    from ocflow_torch.train import TrainState, make_gan_inpainting_step

    rng = np.random.default_rng(7)
    batch = {"image": torch.from_numpy(rng.uniform(-1, 1, (2, 64, 128, 3))),
             "occ": torch.from_numpy((rng.uniform(size=(2, 64, 128, 1)) > 0.6) * 1.0)}
    counters = (cv_mod.cost_volume, cv_mod.cost_volume_backward, conv_chain.conv_group,
                conv_chain.conv_group_diff, conv_chain_q8.conv_group_q8)
    out = {}
    for dtype in (torch.float64, torch.float32):
        for dev in ("cpu", cuda_device):
            gen = InpaintSANet(generator=torch.Generator().manual_seed(1))
            with torch.no_grad():
                gen.refine_attn.gamma.fill_(0.5)
            dis = InpaintSADiscriminator(generator=torch.Generator().manual_seed(2))
            gen, dis = gen.to(dev, dtype), dis.to(dev, dtype)
            states = (TrainState(gen, torch.optim.SGD(gen.parameters(), lr=0.05)),
                      TrainState(dis, torch.optim.SGD(dis.parameters(), lr=0.05)))
            for c in counters:
                c.launches = 0
            _, metrics = make_gan_inpainting_step({})(
                states, {k: v.to(dev, dtype) for k, v in batch.items()})
            assert [c.launches for c in counters] == [0] * 5
            grads = {f"{n}.{k}": p.grad.cpu().double() for n, m in (("G", gen), ("D", dis))
                     for k, p in m.named_parameters()}
            stats = {f"{n}.{k}": v.cpu().double() for n, m in (("G", gen), ("D", dis))
                     for k, v in m.state_dict().items()
                     if k.endswith(("running_mean", "running_var", ".u", ".sigma"))}
            out[(dtype, str(dev))] = ({k: v.item() for k, v in metrics.items()}, grads, stats)
    (mc, gc, sc), (mg, gg, sg) = out[(torch.float64, "cpu")], out[(torch.float64, "cuda")]
    for k, v in mc.items():
        assert abs(mg[k] - v) <= 1e-9 * abs(v), k
    for net in ("G", "D"):
        scale = max(v.abs().max().item() for k, v in gc.items() if k.startswith(net))
        for k, v in gc.items():
            if not k.startswith(net):
                continue
            if v.abs().max() <= 1e-12 * scale:
                assert gg[k].abs().max() <= 1e-12 * scale, k
            else:
                assert (gg[k] - v).abs().max() <= 1e-9 * v.abs().max(), k
    for k, v in sc.items():
        assert (sg[k] - v).abs().max() <= 1e-9 * v.abs().max(), k
    (m32c, _, _), (m32g, _, _) = out[(torch.float32, "cpu")], out[(torch.float32, "cuda")]
    gaps = {k: abs(m32g[k] - v) / abs(v) for k, v in m32c.items()}
    print("fp32 GAN step, card vs CPU, metrics relative:", gaps)
    assert gaps["d_loss"] <= 1e-4 and gaps["g_loss"] <= 1e-4, gaps


def _joint_batch(dev, b=2, h=64, w=128, seed=11):
    g = torch.Generator().manual_seed(seed)
    valid = (torch.rand((b, h, w, 1), generator=g) < 0.3).float()
    return {"images": (torch.rand((b, h, w, 6), generator=g) * 2 - 1).to(dev),
            "flow": ((torch.rand((b, h, w, 2), generator=g) * 10 - 5) * valid).to(dev),
            "valid": valid.to(dev)}


def test_bf16_joint_step_on_gpu_launches_the_cost_volume(cuda_device):
    """One bf16 joint step (``train.steps_joint``: FlowOccNetCV + InpaintingNet,
    seeded, 2x64x128, valid on ~30% of the pixels) on the card: 5 cost-volume
    launches and 5 backward (no conv-group kernel), the master weights fp32;
    against the same bf16 step on the plain cost volume (forward and
    backward), every metric within 2e-2 relative."""
    import copy

    from torch import nn

    from ocflow_torch.models import InpaintingNet
    from ocflow_torch.train import TrainState
    from ocflow_torch.train.steps_joint import make_joint_step

    base = nn.ModuleDict({"flow_occ": FlowOccNetCV(generator=torch.Generator().manual_seed(0)),
                          "inpaint": InpaintingNet(generator=torch.Generator().manual_seed(1))})
    batch = _joint_batch(cuda_device)
    step = make_joint_step({"dtype": "bfloat16"})[0]
    out = {}
    for plain in (False, True):
        pair = copy.deepcopy(base).to(cuda_device)
        state = TrainState(pair, torch.optim.Adam(pair.parameters(), lr=1e-4))
        for c in (cv_mod.cost_volume, cv_mod.cost_volume_backward, conv_chain.conv_group,
                  conv_chain.conv_group_diff):
            c.launches = 0
        saved = fon.cost_volume
        if plain:
            fon.cost_volume = cv_mod.cost_volume_plain
        try:
            _, metrics = step(state, batch)
        finally:
            fon.cost_volume = saved
        torch.cuda.synchronize()
        launches = (cv_mod.cost_volume.launches, cv_mod.cost_volume_backward.launches,
                    conv_chain.conv_group.launches, conv_chain.conv_group_diff.launches)
        assert launches == ((0, 0, 0, 0) if plain else (5, 5, 0, 0)), launches
        assert all(p.dtype == torch.float32 for p in pair.parameters())
        out[plain] = {k: v.item() for k, v in metrics.items()}
    rel = {k: abs(out[False][k] - v) / max(abs(v), 1e-30) for k, v in out[True].items() if v}
    print("bf16 joint step, kernel vs plain cost volume, metrics relative:", rel)
    assert max(rel.values()) <= 2e-2, rel


def test_gc_step_on_gpu_matches_cpu(cuda_device):
    """One TwoStageModelGC step (SimpleOcclusionNet + InpaintingNet, seeded,
    2x64x128, ground-truth flow, pixel-wise, the gated Adam) on the card
    against the CPU in fp64 (cuDNN's fp64 convolutions): every metric within
    1e-9 relative, every gradient within 1e-9 of its tensor's max|grad|
    (those zero but for rounding within 1e-12 of the net's); no kernel of
    the repository launches."""
    from torch import nn

    from ocflow_torch.models import InpaintingNet, SimpleOcclusionNet
    from ocflow_torch.train import TrainState
    from ocflow_torch.train.steps_two_stage import (make_two_stage_gc_optimizer,
                                                    make_two_stage_gc_step)

    g = torch.Generator().manual_seed(12)
    batch = {"images": torch.rand((2, 64, 128, 6), generator=g) * 2 - 1,
             "flow": torch.randn((2, 64, 128, 2), generator=g) * 3}
    out = {}
    for dev in ("cpu", cuda_device):
        pair = nn.ModuleDict({
            "occ": SimpleOcclusionNet(generator=torch.Generator().manual_seed(2)),
            "inpaint": InpaintingNet(generator=torch.Generator().manual_seed(3))}).to(
            dev, torch.float64)
        state = TrainState(pair, make_two_stage_gc_optimizer(pair, 1e-3, 1e-4, 0))
        cv_mod.cost_volume.launches = cv_mod.cost_volume_backward.launches = 0
        _, metrics = make_two_stage_gc_step({})[0](
            state, {k: v.to(dev, torch.float64) for k, v in batch.items()})
        assert cv_mod.cost_volume.launches == cv_mod.cost_volume_backward.launches == 0
        out[str(dev)] = ({k: v.item() for k, v in metrics.items()},
                         {k: p.grad.cpu() for k, p in pair.named_parameters()})
    (mc, gc), (mg, gg) = out["cpu"], out["cuda"]
    for k, v in mc.items():
        assert abs(mg[k] - v) <= 1e-9 * abs(v), k
    for net in ("occ", "inpaint"):
        scale = max(v.abs().max().item() for k, v in gc.items() if k.startswith(net))
        for k, v in gc.items():
            if not k.startswith(net):
                continue
            if v.abs().max() <= 1e-12 * scale:
                assert gg[k].abs().max() <= 1e-12 * scale, k
            else:
                assert (gg[k] - v).abs().max() <= 1e-9 * v.abs().max(), k


def test_imported_lightning_flownetcv_serves_through_the_kernels(cuda_device, tmp_path):
    """A Lightning checkpoint of the original FlowNetCV (``model.`` keys,
    the dead ``deconv2``) through ``tools.import_weights`` and
    ``load_model`` onto the card: the weights bit for bit, fp32
    ``fast_apply`` through the kernels within 1e-4 of max|flow| of the
    eager forward on the plain cost volume."""
    from ocflow_torch.models import load_model
    from ocflow_torch.tools import import_weights

    seeded = FlowNetCV(generator=torch.Generator().manual_seed(3))
    sd = {f"model.{k}": v for k, v in seeded.state_dict().items()}
    sd["model.deconv2.weight"], sd["model.deconv2.bias"] = torch.zeros(2, 2, 4, 4), torch.zeros(2)
    torch.save({"state_dict": sd, "epoch": 1}, tmp_path / "trained.ckpt")
    (entry,) = import_weights.convert_file(str(tmp_path / "trained.ckpt"), str(tmp_path))
    assert (entry["family"], entry["key"]) == ("flow", "pwc")
    model = load_model("flow", "pwc", entry["output"], cuda_device)
    for k, v in seeded.state_dict().items():
        assert torch.equal(model.state_dict()[k].cpu(), v), k
    x = torch.rand((2, 64, 128, 6), generator=torch.Generator().manual_seed(4))
    x = (x * 2 - 1).to(cuda_device)
    cv_mod.cost_volume.launches = 0
    fast = fast_apply(model, x)
    torch.cuda.synchronize()
    assert cv_mod.cost_volume.launches == 5
    with torch.no_grad(), _plain_cost_volume():
        ref = model(x)
    for f, r in zip(fast, ref):
        assert (f - r).abs().max().item() <= 1e-4 * r.abs().max().item()
