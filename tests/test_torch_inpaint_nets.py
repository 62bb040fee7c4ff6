"""InpaintingNet against the JAX package's, on the CPU at 2x64x128, through
the weight bridges both ways (the JAX package's ``convert_inpainting_net``
from the port's ``state_dict``; the port's ``inpaintingnet_from_flax`` back
from those flax variables); the panels against the JAX panels.
OCFlowNet is ``tests/test_torch_inpaint_ocflownet.py``, under the same
bounds.

Eval mode (running statistics perturbed from a seed, fp32): outputs within
1e-4 of max|out|. Train mode (the batch's statistics, the running ones
updated): both packages in fp64 (``jax_enable_x64``), outputs within 1e-6
of max|out| and the updated statistics within 1e-5 of max|stat|; in fp32
the statistics within 1e-5. The fp32 train-mode outputs are not held at
1e-4: twelve train-mode BatchNorms, the deepest over 4 values a channel at
1x2 (2 images), carry fp32 rounding far; over seeds 0-2 and batches of 2-8
at 64x128 the port's fp32 output read 4e-5-1.7e-4 from its fp64 output and
the JAX package's 8e-5-4.4e-4 (measured on the CPU when the net was
ported); here they are held within 1e-3. The JAX forwards are jitted (one
compile each instead of one per op).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocflow_torch.bench import perturb_batchnorm
from ocflow_torch.models import InpaintingNet, inpaintingnet_from_flax
from ocflow_torch.utils import panels as tpanels
from ocflow_tpu.models import inpainting_net as jinp
from ocflow_tpu.models import torch_convert as tc
from ocflow_tpu.utils import panels as jpanels
from test_torch_ops import share_cores  # noqa: F401  (autouse)

EVAL_REL, FP64_REL, STATS_REL, FP32_TRAIN_REL = 1e-4, 1e-6, 1e-5, 1e-3
JAPPLY = jax.jit(jinp.InpaintingNet().apply)
JTRAIN = jax.jit(functools.partial(jinp.InpaintingNet().apply, train=True,
                                   mutable=["batch_stats"]))


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


def _inputs(seed, b=2, h=64, w=128):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32)
    masks = (rng.uniform(size=(b, h, w, 1)) > 0.6).astype(np.float32)
    return imgs, masks


def _seeded(seed):
    model = InpaintingNet(generator=torch.Generator().manual_seed(seed))
    perturb_batchnorm(model, torch.Generator().manual_seed(seed + 100))
    return model


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("seed", [0, 1])
def test_inpainting_net_eval_matches_jax(seed):
    """Port weights -> flax (the JAX converter), the eval forward; and the
    flax variables back through ``inpaintingnet_from_flax`` equal the
    port's ``state_dict``."""
    model = _seeded(seed).eval()
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    variables = tc.convert_inpainting_net(sd)
    back = inpaintingnet_from_flax(variables)
    assert set(back) == set(sd)
    assert all(torch.equal(back[k].to(sd[k].dtype), sd[k]) for k in sd)
    imgs, masks = _inputs(seed)
    want = JAPPLY(variables, jnp.asarray(imgs), jnp.asarray(masks))
    with torch.no_grad():
        got = model(torch.from_numpy(imgs), torch.from_numpy(masks))
    assert got.shape == (2, 64, 128, 3)
    assert _rel(got.numpy(), want) <= EVAL_REL


def _train_forward(model, variables, imgs, masks, fp64):
    dt, jdt = (torch.float64, jnp.float64) if fp64 else (torch.float32, jnp.float32)
    with jax.enable_x64(fp64):
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), t)  # noqa: E731
        want, upd = JTRAIN(cast(variables), jnp.asarray(imgs, jdt), jnp.asarray(masks, jdt))
        want, stats = np.asarray(want), _np_tree(upd["batch_stats"])
    model = model.to(dt).train()
    with torch.no_grad():
        got = model(torch.from_numpy(imgs).to(dt), torch.from_numpy(masks).to(dt))
    return got.numpy(), want, stats


@pytest.mark.parametrize("fp64", [True, False], ids=["fp64", "fp32"])
def test_inpainting_net_train_mode_matches_jax(fp64):
    """The train-mode forward and the running statistics it leaves, as the
    module docstring states."""
    model = _seeded(2)
    variables = tc.convert_inpainting_net({k: v.clone() for k, v in model.state_dict().items()})
    imgs, masks = _inputs(2)
    got, want, stats = _train_forward(model, variables, imgs, masks, fp64)
    assert _rel(got, want) <= (FP64_REL if fp64 else FP32_TRAIN_REL)
    have = inpaintingnet_from_flax({"params": variables["params"], "batch_stats": stats})
    sd = model.state_dict()
    for k, v in have.items():
        if "running" in k:
            assert _rel(sd[k].numpy(), v.numpy()) <= STATS_REL, k


def test_panels_equal_jax_panels():
    rng = np.random.default_rng(0)
    img = lambda: rng.uniform(-1.2, 1.2, (16, 24, 3)).astype(np.float32)  # noqa: E731
    flow = lambda: rng.normal(size=(16, 24, 2)).astype(np.float32) * 4  # noqa: E731
    occ = lambda: rng.uniform(-0.1, 1.1, (16, 24, 1)).astype(np.float32)  # noqa: E731
    cases = [("occlusion_panel", (img(), img(), occ(), occ())),
             ("occlusion_panel", (img(), img(), occ())),
             ("inpainting_panel", (img(), img(), img(), img())),
             ("pipeline_panel", (img(), img(), flow(), img(), occ(), img())),
             ("pipeline_grid", (img(), img(), img(), img(), img(), img(), flow(), flow(),
                                occ(), occ())),
             ("flow_panel", (img(), img(), flow(), flow())),
             ("warp_panel", (img(), img(), img(), flow()))]
    for name, args in cases:
        got, want = getattr(tpanels, name)(*args), getattr(jpanels, name)(*args)
        assert got.dtype == want.dtype == np.uint8 and np.array_equal(got, want), name
