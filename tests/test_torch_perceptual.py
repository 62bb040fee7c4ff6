"""The VGG16 perceptual loss of the port (``losses.perceptual``) against
``ocflow_tpu.losses.perceptual`` on the CPU.

- The ``.npz`` layout: the JAX package's seeded VGG16 (``init_vgg16(
  PRNGKey(0))``) written as ``conv{i}_kernel`` / ``conv{i}_bias`` and
  loaded by both packages; the port's ``vgg16_from_flax`` bridge gives the
  same weights. On it, at 2x64x128: the four block activations within 1e-4
  of max|JAX| and the loss within 1e-5 relative in fp32; the loss's
  gradient in the prediction within 1e-4 of max|grad| in fp64 (read
  1e-15), in fp32 within ``FP32_GRAD_L2`` relative L2 (read 8.6e-4-1.3e-3: each
  L1 term's sign flips where the two features differ by a rounding); the
  VGG's own parameters get no gradient.
- ``convert_torch_vgg16``: a torchvision-named state_dict (seeded, all 13
  convs) gives the JAX converter's ``.npz`` key for key, and loads into
  ``VGG16Features`` by its own names.
- The inpainting stage step with ``loss_type: vgg`` against the JAX
  package's, fp64 in both (InpaintingNet): the metrics within 1e-5
  relative, the gradients within 1e-4 of their max|grad|. The GAN step's:
  ``tests/test_torch_perceptual_gan.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from ocflow_torch.losses.perceptual import (VGG16_CFG, VGG16Features, convert_torch_vgg16,
                                            init_vgg16, vgg_perceptual_loss)
from ocflow_torch.models import InpaintingNet
from ocflow_torch.models.convert import vgg16_from_flax
from ocflow_torch.train import TrainState, make_inpainting_stage_step
from ocflow_tpu.losses import perceptual as jper
from ocflow_tpu.models import inpainting_net as jinp
from ocflow_tpu.models import torch_convert as tc
from ocflow_tpu.train import TrainState as JTrainState
from ocflow_tpu.train import steps_inpainting as jsteps
from test_torch_gan_step import hold_tensors, leaves
from test_torch_inpaint_step_sup import make_batch
from test_torch_ops import share_cores  # noqa: F401  (autouse)
from test_torch_two_stage_step import recording, seeded, snap_grads

REL, LOSS_REL, GRAD_REL, FP32_GRAD_L2 = 1e-4, 1e-5, 1e-4, 1e-2


def _jax_vgg(tmp_path):
    """The JAX package's seeded VGG16 and its ``.npz``."""
    net, variables = jper.init_vgg16(jax.random.PRNGKey(0))
    p = variables["params"]
    path = str(tmp_path / "vgg16.npz")
    np.savez(path, **{f"conv{i}_{t}": np.asarray(p[f"Conv_{i}"][t])
                      for i in range(10) for t in ("kernel", "bias")})
    return net, jax.tree_util.tree_map(np.asarray, variables), path


def _images(seed=0, b=2, h=64, w=128):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32) for _ in range(2)]


def test_vgg_features_and_loss_match_jax(tmp_path):
    net, variables, path = _jax_vgg(tmp_path)
    _, loaded = jper.init_vgg16(jax.random.PRNGKey(5), path)  # the JAX loader, same file
    vgg = init_vgg16(weights_path=path)
    bridged = vgg16_from_flax(variables)
    assert all(torch.equal(v, vgg.state_dict()[k]) for k, v in bridged.items())
    assert all(not p.requires_grad for p in vgg.parameters()) and not vgg.training
    pred, target = _images()
    want = jax.jit(net.apply)(loaded, jnp.asarray(pred))
    got = vgg(torch.from_numpy(pred))
    for g, w in zip(got, want, strict=True):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.detach().numpy() - w).max() <= REL * np.abs(w).max()

    for fp64 in (False, True):
        dt = np.float64 if fp64 else np.float32
        with jax.enable_x64(fp64):
            jvars = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt), loaded)
            # the weights and the target as arguments: XLA would fold a
            # constant target's VGG forward at compile time
            jl, jg = jax.jit(jax.value_and_grad(
                lambda p, v, t: jper.vgg_perceptual_loss(net.apply, v, p, t)))(
                jnp.asarray(pred, dt), jvars, jnp.asarray(target, dt))
            jl, jg = float(jl), np.asarray(jg)
        model = vgg.double() if fp64 else vgg
        x = torch.from_numpy(pred.astype(dt)).requires_grad_(True)
        loss = vgg_perceptual_loss(model, x, torch.from_numpy(target.astype(dt)))
        loss.backward()
        assert abs(loss.item() - jl) <= LOSS_REL * abs(jl)
        gap = np.abs(x.grad.numpy() - jg).max() / np.abs(jg).max()
        l2 = np.linalg.norm(x.grad.numpy() - jg) / np.linalg.norm(jg)
        print(f"{'fp64' if fp64 else 'fp32'}: the loss's input gradient {gap:.3e} of max, "
              f"relative L2 {l2:.3e}")
        assert gap <= GRAD_REL if fp64 else l2 <= FP32_GRAD_L2
        assert all(p.grad is None for p in model.parameters())


def test_convert_torch_vgg16_matches_jax(tmp_path):
    g = torch.Generator().manual_seed(3)
    sd, idx, cin = {}, 0, 3
    for v in VGG16_CFG + ("M", 512, 512, 512):  # torchvision's 13 convs
        if v == "M":
            idx += 1
            continue
        sd[f"features.{idx}.weight"] = torch.randn((v, cin, 3, 3), generator=g)
        sd[f"features.{idx}.bias"] = torch.randn((v,), generator=g)
        idx, cin = idx + 2, v
    torch.save(sd, tmp_path / "vgg16.pth")
    convert_torch_vgg16(str(tmp_path / "vgg16.pth"), str(tmp_path / "port.npz"))
    jper.convert_torch_vgg16(str(tmp_path / "vgg16.pth"), str(tmp_path / "jax.npz"))
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(a.files) == sorted(b.files) and len(a.files) == 20
    assert all(np.array_equal(a[k], b[k]) for k in a.files)
    model = VGG16Features()
    model.load_state_dict({k: v for k, v in sd.items() if k in model.state_dict()})
    loaded = init_vgg16(weights_path=str(tmp_path / "port.npz"))
    assert all(torch.equal(v, loaded.state_dict()[k]) for k, v in model.state_dict().items())


def test_stage_step_with_the_vgg_loss_matches_jax(tmp_path):
    net, variables, path = _jax_vgg(tmp_path)
    model = seeded(InpaintingNet, 0)
    flax_vars = tc.convert_inpainting_net({k: v.clone() for k, v in model.state_dict().items()})
    batch = make_batch("stage")
    hparams = {"loss_type": "vgg", "reconst_weight": 0.5}
    with jax.enable_x64(True):
        cast = functools.partial(jax.tree_util.tree_map, lambda a: jnp.asarray(a, jnp.float64))
        jstate = JTrainState.create(apply_fn=jinp.InpaintingNet().apply,
                                    params=cast(flax_vars["params"]),
                                    tx=recording(optax.adam(1e-3)),
                                    batch_stats=cast(flax_vars["batch_stats"]))
        jtrain, _ = jsteps.make_inpainting_stage_step(hparams, vgg=(net.apply, cast(variables)))
        jstate, jm = jtrain(jstate, {k: jnp.asarray(v, jnp.float64) for k, v in batch.items()})
        jm = {k: float(v) for k, v in jm.items()}
    model = model.double()
    state = TrainState(model, torch.optim.Adam(model.parameters(), lr=1e-3))
    state.optimizer.named_params = dict(model.named_parameters())
    grads = []
    snap_grads(state.optimizer, grads)
    train_step, _ = make_inpainting_stage_step(hparams, init_vgg16(weights_path=path).double())
    state, m = train_step(state, {k: torch.from_numpy(v).double() for k, v in batch.items()})
    assert set(m) == set(jm) == {"loss", "vgg_loss", "reconst_loss"}
    for k, v in jm.items():
        assert abs(m[k].item() - v) <= LOSS_REL * abs(v), k
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    sd.update(grads[0])
    hold_tensors("stage vgg", leaves(tc.convert_inpainting_net(sd)["params"]),
                 leaves(jstate.opt_state[0]), GRAD_REL)
