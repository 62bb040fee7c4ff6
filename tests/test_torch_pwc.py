"""The port's FlowNetCV / PWCNet (eager and ``fast_apply``) == the JAX modules.

Seeded port weights are mapped to flax variables through
``ocflow_tpu.models.torch_convert.convert_flownetcv``; both packages then run
the same fp32 input on the CPU. Bounds are those of tests/test_pwc_fast.py:
2e-4 on the quarter-res flow (x5), 2e-3 on the full-res flow (x20).
"""

import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocflow_torch.models import (FlowNetCV, PWCNet, fast_apply, flownetcv_from_flax,
                                 prepare)
from ocflow_tpu.models import pwc_net as jpwc
from ocflow_tpu.models.torch_convert import convert_flownetcv
from test_torch_ops import share_cores  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
QUARTER_ATOL, FULL_ATOL = 2e-4, 2e-3


def _input(seed, b=2, h=64, w=128):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (b, h, w, 6)).astype(np.float32)


@pytest.mark.parametrize("port_cls, jax_cls", [
    (FlowNetCV, jpwc.FlowNetCV), (PWCNet, jpwc.PWCNet)])
def test_forward_matches_jax(port_cls, jax_cls):
    model = port_cls(generator=torch.Generator().manual_seed(0))
    variables = convert_flownetcv(model.state_dict())
    x = _input(1)
    ref_full, ref_quarter = jax.jit(jax_cls().apply)(variables, jnp.asarray(x))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        eager = model(xt)
    fast = fast_apply(model, xt, device="cpu")
    for full, quarter in (eager, fast):
        assert full.shape == (2, 64, 128, 2) and quarter.shape == (2, 16, 32, 2)
        np.testing.assert_allclose(quarter.numpy(), np.asarray(ref_quarter),
                                   atol=QUARTER_ATOL)
        np.testing.assert_allclose(full.numpy(), np.asarray(ref_full),
                                   atol=FULL_ATOL)


def test_fast_apply_takes_a_state_dict_and_caches_packing():
    model = FlowNetCV(generator=torch.Generator().manual_seed(2))
    xt = torch.from_numpy(_input(3, b=1))
    a = fast_apply(model, xt, device="cpu")
    b = fast_apply(model.state_dict(), xt, device="cpu")
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u.numpy(), v.numpy())
    packed = prepare(model, torch.float32, "cpu")
    assert list(model.__dict__["_fast_weights"][1]) == [
        (torch.float32, torch.device("cpu"))]
    fast_apply(model, xt, device="cpu")
    assert prepare(model, torch.float32, "cpu") is packed


def test_fast_apply_repacks_after_the_weights_change():
    """New weights (load_state_dict, an in-place edit) reach the kernels'
    packed copy: the result is that of a fresh model with those weights."""
    model = FlowNetCV(generator=torch.Generator().manual_seed(5))
    other = FlowNetCV(generator=torch.Generator().manual_seed(6))
    xt = torch.from_numpy(_input(7, b=1, w=64))
    fast_apply(model, xt, device="cpu")  # packs the first weights
    model.load_state_dict(other.state_dict())
    for u, v in zip(fast_apply(model, xt, device="cpu"),
                    fast_apply(other, xt, device="cpu")):
        np.testing.assert_array_equal(u.numpy(), v.numpy())
    before = fast_apply(model, xt, device="cpu")
    with torch.no_grad():
        model.context.convs()[-1].bias.add_(1.0)
    fresh = FlowNetCV()
    fresh.load_state_dict(model.state_dict())
    for u, v, w in zip(fast_apply(model, xt, device="cpu"),
                       fast_apply(fresh, xt, device="cpu"), before):
        np.testing.assert_array_equal(u.numpy(), v.numpy())
        assert not np.array_equal(u.numpy(), w.numpy())


def test_fast_apply_needs_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    model = FlowNetCV()
    with pytest.raises(RuntimeError, match="CUDA"):
        fast_apply(model, torch.zeros(1, 64, 64, 6))


def test_bench_measures_on_cpu_and_needs_cuda_by_default():
    """The bench's timing loop runs on the CPU at a tiny size when asked;
    its entry point refuses to run without a card unless given the CPU."""
    from ocflow_torch import bench

    model, x = bench.make_inputs(1, 64, 64, torch.float32, "cpu", seed=0)
    assert x.shape == (1, 64, 64, 6) and float(x.abs().max()) <= 1.0
    res = bench.measure(model, x, iters=1, warmup=0)
    assert res["ms_per_batch"] > 0 and res["pairs_per_sec"] > 0
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main([])


def test_flownetcv_from_flax_round_trip():
    """flax params -> port state_dict -> convert_flownetcv -> identical."""
    shapes = jax.eval_shape(jpwc.FlowNetCV().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 6)))
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    sd = flownetcv_from_flax(params)
    FlowNetCV().load_state_dict(sd)  # every key and shape fits the module
    back = convert_flownetcv(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)


def test_port_imports_neither_jax_nor_ocflow_tpu():
    code = (
        "import pkgutil, importlib, sys, ocflow_torch\n"
        "for m in pkgutil.walk_packages(ocflow_torch.__path__, 'ocflow_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'ocflow_tpu',\n"
        "       'cv2')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|ocflow_tpu|cv2)\b"
        r"|import_module\(\s*['\"](jax|flax|ocflow_tpu|cv2)", re.M)
    files = sorted((REPO / "ocflow_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 5
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders


def test_fp32_paths_pin_cudnn_convolutions_to_fp32(monkeypatch):
    """fp32 ``fast_apply`` (serving and ``diff``) runs its cuDNN
    convolutions with TF32 off whatever the caller's flag, and gives the
    flag back; bf16 leaves it alone. (PyTorch's default TF32 flag moved the
    fp32 forward to 1.06e-4 of max|flow| on the H100, over the port's
    1e-4; tests/test_torch_gpu.py holds the card run.)"""
    seen = []
    conv2d = torch.nn.functional.conv2d

    def spy(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    model = FlowNetCV(generator=torch.Generator().manual_seed(4))
    xt = torch.from_numpy(_input(5, b=1))
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for diff in (False, True):
            seen.clear()
            fast_apply(model, xt, device="cpu", diff=diff)
            assert seen and not any(seen), diff
            assert torch.backends.cudnn.allow_tf32
        seen.clear()
        fast_apply(model.bfloat16(), xt.bfloat16(), device="cpu")
        assert seen and all(seen)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
