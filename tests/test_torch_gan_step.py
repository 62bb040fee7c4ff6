"""One SN-PatchGAN train step of the port
(``ocflow_torch.train.make_gan_inpainting_step``) against
``ocflow_tpu.train.steps_inpainting.make_gan_inpainting_step`` in fp64 on the
CPU, with the projected generator and discriminator (``gated``); the plain
ones (``gated_org``) in ``tests/test_torch_gan_step_org.py``. The helpers
serve that file and ``tests/test_torch_gan_step_adam.py`` too.

2x64x128 (the discriminators' five stride-2 maps end at 1x3 there; at 32x64
the fifth has no row, ``in/2 - 1`` each, and the hinge losses would be means
over nothing). The generator's weights are ``tests/test_torch_gan_nets.py``'s
(seeded, ``gamma`` 0.5, BatchNorms perturbed); the discriminator's, its
``u`` included, flax's ``init`` from a seed; both carried across. Both
packages in fp64 (``jax.enable_x64``; the port's models ``.double()``), each
state's optimizer SGD at ``LR`` (the JAX one stores each gradient it is
given as its state), so the discriminator's step moves its weights before
the generator is held against it. Held within 1e-9: every metric
(relative), every gradient of G and of D (of its tensor's max|grad|), G's
BatchNorm statistics after the step (one update, of max|stat|), D's ``u``
and ``sigma`` after the step (one update, from the D step). Some of G's
tensors have a gradient that is exactly zero: the biases of a tower's last
convs, whose per-channel shift the train-mode BatchNorm's mean removes, and
the key conv's bias, which shifts each query's scores by one constant that
the softmax ignores. Both packages read rounding there (up to 1e-16 where
the net's max|grad| is 0.1), so those tensors (the JAX gradient within
``ZERO`` of the net's max|grad|) are held in absolute terms: both packages'
values within ``ZERO`` of the net's max|grad|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from ocflow_torch.models import (InpaintSADiscriminator, InpaintSADiscriminatorOrg,
                                 discriminator_from_flax)
from ocflow_torch.train import TrainState, make_gan_inpainting_step
from ocflow_tpu.models import gated_conv as jg
from ocflow_tpu.models import torch_convert as tc
from ocflow_tpu.train import TrainState as JTrainState
from ocflow_tpu.train import steps_inpainting as jsteps
from test_torch_gan_nets import NETS, flax_variables, port_model
from test_torch_ops import share_cores  # noqa: F401  (autouse)

REL = 1e-9
ZERO = 1e-12
LR = 0.05
B, H, W = 2, 64, 128
DIS = {"gated": (jg.InpaintSADiscriminator, InpaintSADiscriminator, True),
       "gated_org": (jg.InpaintSADiscriminatorOrg, InpaintSADiscriminatorOrg, False)}


def capture_sgd(lr):
    """``optax.sgd(lr)`` whose state is the last gradient it was given."""
    return optax.GradientTransformation(
        init=lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        update=lambda grads, state, params=None: (
            jax.tree_util.tree_map(lambda g: -lr * g, grads), grads))


def make_batch(seed=7):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(-1, 1, (B, H, W, 3)),
            "occ": (rng.uniform(size=(B, H, W, 1)) > 0.6).astype(np.float64)}


def dis_variables(key, seed=3):
    """flax ``init`` of the discriminator (numpy, fp32)."""
    x = np.zeros((1, H, W, 4), np.float32)
    return jax.tree_util.tree_map(np.array, jax.jit(DIS[key][0]().init)(
        jax.random.PRNGKey(seed), x))


def dis_to_flax(tensors, projected):
    """Port discriminator tensors (``state_dict`` names) as flax's
    ``(params, batch_stats)``: kernels OIHW -> HWIO, each spectral norm's
    ``u`` and ``sigma`` under ``SpectralNorm_0``."""
    params, stats = {}, {}
    for i in range(5):
        paths = ([(f"_ProjConv_{i}", f"_Conv_{j}") for j in range(3)] if projected
                 else [(f"_Conv_{i}",)])
        for j, path in enumerate(paths):
            name = f"discriminator_net.{i}.conv2d" + (f".conv{j + 1}" if projected else "")
            p, s = params, stats
            for k in path:
                p, s = p.setdefault(k, {}), s.setdefault(k, {})
            p["Conv_0"] = {"kernel": tensors[f"{name}.weight"].numpy().transpose(2, 3, 1, 0),
                           "bias": tensors[f"{name}.bias"].numpy()}
            if f"{name}.u" in tensors:
                s["SpectralNorm_0"] = {"Conv_0/kernel/u": tensors[f"{name}.u"].numpy(),
                                       "Conv_0/kernel/sigma": tensors[f"{name}.sigma"].numpy()}
    return params, stats


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def per_tensor(got, want):
    assert set(got) == set(want)
    return {k: float(np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-300))
            for k, w in want.items()}


def zero_tensors(grads):
    """The names of the gradients (``{name: array}``) that are zero up to
    rounding (the module docstring's kind): within ``ZERO`` of their max|.|."""
    scale = max(np.abs(g).max() for g in grads.values())
    return {k for k, g in grads.items() if np.abs(g).max() <= ZERO * scale}


def hold_tensors(what, got, want, rel=REL, zero=None):
    """Each tensor within ``rel`` of its max|.|, but the tensors ``zero``
    (default: ``zero_tensors(want)``, held within ``ZERO`` of the net's
    max|.|), held in both packages within ``rel`` of the net's max|.|.
    Returns their names."""
    scale = max(np.abs(w).max() for w in want.values())
    if zero is None:
        zero, rel_zero = zero_tensors(want), ZERO
    else:
        rel_zero = rel
    for k in zero:
        assert np.abs(got[k]).max() <= rel_zero * scale, (what, k)
        assert np.abs(want[k]).max() <= rel_zero * scale, (what, k)
    errs = per_tensor({k: got[k] for k in want if k not in zero},
                      {k: w for k, w in want.items() if k not in zero})
    worst = max(errs, key=errs.get)
    assert errs[worst] <= rel, (what, worst, errs[worst])
    return zero


def run_gan_steps(key, kind="fp64", jax_tx=capture_sgd, port_opt=torch.optim.SGD,
                  dis_lr_scale=1.0, vgg=None):
    """One GAN step of both packages from the same weights and batch in
    ``kind``; the optimizers ``jax_tx(lr)`` / ``port_opt(params, lr=lr)``,
    D's learning rate ``dis_lr_scale * LR``; with ``vgg`` (``(JAX apply,
    JAX variables, port VGG16Features)``) the ``loss_type: vgg`` step.
    Returns the port's ``(gen_state, dis_state)`` and metrics, the JAX
    states and metrics."""
    jgcls, _, _, _ = NETS[key]
    jdcls, tdcls, projected = DIS[key]
    fp64 = kind == "fp64"
    npdt, dt = (np.float64, torch.float64) if fp64 else (np.float32, torch.float32)
    gv, dv = flax_variables(key, seed=1), dis_variables(key)
    batch = {k: v.astype(npdt) for k, v in make_batch().items()}
    with jax.enable_x64(fp64):
        cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, npdt), t)  # noqa: E731
        jgen = JTrainState.create(apply_fn=jgcls().apply, params=cast(gv["params"]),
                                  tx=jax_tx(LR), batch_stats=cast(gv["batch_stats"]))
        jdis = JTrainState.create(apply_fn=jdcls().apply, params=cast(dv["params"]),
                                  tx=jax_tx(dis_lr_scale * LR),
                                  batch_stats=cast(dv["batch_stats"]))
        hparams = {"loss_type": "pixel-wise" if vgg is None else "vgg"}
        step = jsteps.make_gan_inpainting_step(
            hparams, vgg=None if vgg is None else (vgg[0], cast(vgg[1])))
        jgen, jdis, jmetrics = step(jgen, jdis, {k: jnp.asarray(v) for k, v in batch.items()})
        jmetrics = {k: float(v) for k, v in jmetrics.items()}
    gen = port_model(key, gv, dt)
    dis = tdcls()
    dis.load_state_dict(discriminator_from_flax(dv, projected))
    dis = dis.to(dt)
    states = (TrainState(gen, port_opt(gen.parameters(), lr=LR)),
              TrainState(dis, port_opt(dis.parameters(), lr=dis_lr_scale * LR)))
    train_step = make_gan_inpainting_step(hparams, None if vgg is None else vgg[2].to(dt))
    states, metrics = train_step(states, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert states[0].step == states[1].step == 1
    return states, {k: v.item() for k, v in metrics.items()}, (jgen, jdis), jmetrics


def gen_flax(model, grads=False):
    """The port generator's tensors as the JAX package's
    ``convert_inpaint_sanet`` reads them; with ``grads``, each parameter's
    gradient in its place."""
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    if grads:
        sd.update({k: p.grad.clone() for k, p in model.named_parameters()})
    return tc.convert_inpaint_sanet(sd, projected=not model.org)


def check_gan_step(key):
    (gs, ds), metrics, (jgen, jdis), jmetrics = run_gan_steps(key)
    assert set(metrics) == set(jmetrics) == {"whole_loss", "d_loss", "g_loss",
                                              "content_loss", "occluded", "non_occluded"}
    for k, v in jmetrics.items():
        assert abs(metrics[k] - v) <= REL * abs(v), (k, metrics[k], v)
    projected = DIS[key][2]
    zero = hold_tensors("G", leaves(gen_flax(gs.model, grads=True)["params"]),
                          leaves(jgen.opt_state))
    assert all("bias" in k for k in zero)
    hold_tensors("D", leaves(dis_to_flax({k: p.grad for k, p in ds.model.named_parameters()},
                                           projected)[0]), leaves(jdis.opt_state))
    for what, got, want in (
            ("G statistics", gen_flax(gs.model)["batch_stats"], jgen.batch_stats),
            ("D u, sigma", dis_to_flax(ds.model.state_dict(), projected)[1], jdis.batch_stats)):
        errs = per_tensor(leaves(got), leaves(want))
        worst = max(errs, key=errs.get)
        assert errs[worst] <= REL, (what, worst, errs[worst])
    # one update each: D's u moved from its draw by the D step alone, G's
    # statistics counted one batch
    assert all(m.num_batches_tracked.item() == 1 for m in gs.model.modules()
               if hasattr(m, "num_batches_tracked"))


def test_gan_step_matches_jax_fp64():
    check_gan_step("gated")
