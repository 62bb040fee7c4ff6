"""The TwoStageModelGC step and its gated optimizer (``train.steps_two_stage.
make_two_stage_gc_step``, ``make_two_stage_gc_optimizer``) against
``ocflow_tpu.train.steps_two_stage``, on the CPU at 2x64x64 over 4 steps
with ``unfreeze_step=2``, ``loss_type: pixel-wise``: a SimpleOcclusionNet
and an inpainter (InpaintingNet, or the projected gated generator with
remat, ``gamma`` 0.5), seeded in the port (BatchNorm statistics perturbed),
carried to flax through the JAX package's converters; a numpy-seeded batch
with ground-truth ``flow`` and ``occ``.

Both packages in fp64 (``jax_enable_x64``). At every step the loss and
every metric within 1e-5 relative, the running statistics of both nets
within 1e-5 of max|stat|; at steps 0 and 1 each gradient within 1e-4 of
its max|grad| (a gradient zero but for rounding within 1e-12 of the net's
max). From step 2 on the gradients are printed, not held: two fp64 runs of
this pipeline drift apart about a thousandfold a step (read 2e-12, 4e-9,
3e-7, 2e-5 of the net's max|grad| at steps 0-3 with InpaintingNet, 1.1e-2
at step 3 with the gated generator), as Adam moves a weight
whose gradient is near its eps (1e-8) by an amount that follows the
gradient's value, and InpaintingNet's deepest train-mode BatchNorms
normalize 2 values a channel.

The gate: the inpainter's parameters equal the seeded ones bit for bit
after steps 0 and 1 in both packages, while its running statistics move
(train mode). The first unfrozen update (step 2): its largest step equals
optax's within 1e-6 relative (``finetune_lr * 0.369 / 0.578``: Adam's bias
corrections ``1 - beta^3``, which they are only if the gated steps were
counted; a count left at 1, as ``torch.optim.Adam`` leaves it for a
``None`` gradient, gives the whole learning rate), the whole update within
``UPDATE_L2`` (relative L2, read 6.3e-5 and 1.6e-4; its elements whose
gradient is near eps follow the drift above). :func:`test_gated_adam_matches_optax` holds the gated
optimizer alone against optax on the same gradients. The pair's bridge
``two_stage_from_flax`` gives back the port's ``state_dict``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from ocflow_torch.models import InpaintingNet, SimpleOcclusionNet, registry
from ocflow_torch.models.convert import (inpaintingnet_from_flax, inpaintsanet_from_flax,
                                         two_stage_from_flax)
from ocflow_torch.train import TrainState
from ocflow_torch.train.steps_two_stage import (make_two_stage_gc_optimizer,
                                                make_two_stage_gc_step)
from ocflow_tpu.models import gated_conv as jgc
from ocflow_tpu.models import inpainting_net as jinp
from ocflow_tpu.models import occlusion_nets as jocc
from ocflow_tpu.models import torch_convert as tc
from ocflow_tpu.train import TrainState as JTrainState
from ocflow_tpu.train import steps_two_stage as jsteps
from test_torch_gan_step import hold_tensors
from test_torch_ops import share_cores  # noqa: F401  (autouse)
from test_torch_two_stage_step import (leaves, make_batch, per_tensor, recording, seeded,
                                       snap_grads)

METRIC_REL, GRAD_REL, STATS_REL, UPDATE_REL, UPDATE_L2 = 1e-5, 1e-4, 1e-5, 1e-6, 1e-3
LR, INPAINT_LR, UNFREEZE, STEPS = 1e-3, 1e-4, 2, 4
HPARAMS = {"loss_type": "pixel-wise", "photo_weight": 1.0, "reconst_weight": 1.0,
           "smooth1_weight": 0.5, "pixelwise_weight": 1.0}


def _inpainter(kind):
    if kind == "simple":
        return seeded(InpaintingNet, 4)
    gen = registry.build("inpainting", "gated", remat=True,
                         generator=torch.Generator().manual_seed(4))
    from ocflow_torch.bench import perturb_batchnorm

    perturb_batchnorm(gen, torch.Generator().manual_seed(104))
    with torch.no_grad():
        gen.refine_attn.gamma.fill_(0.5)
    return gen


INPAINTERS = {"simple": (tc.convert_inpainting_net, inpaintingnet_from_flax,
                         lambda: jinp.InpaintingNet().apply),
              "gated": (functools.partial(tc.convert_inpaint_sanet, projected=True),
                        inpaintsanet_from_flax,
                        lambda: jgc.InpaintSANet(remat=True).apply)}


def pair_flax(model, kind, grads=None):
    """The pair's flax ``{"params", "batch_stats"}`` ``{'occ', 'inpaint'}``
    through the JAX package's converters; with ``grads`` (``{name:
    tensor}`` of the pair) the gradients in the parameters' places."""
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    sd.update(grads or {})
    parts = {"occ": tc.convert_simple_occlusion_net, "inpaint": INPAINTERS[kind][0]}
    out = {"params": {}, "batch_stats": {}}
    for name, convert in parts.items():
        v = convert({k[len(name) + 1:]: t for k, t in sd.items() if k.startswith(name + ".")})
        out["params"][name] = v["params"]
        out["batch_stats"][name] = v.get("batch_stats", {})
    return out


def run(kind):
    model = nn.ModuleDict({"occ": seeded(SimpleOcclusionNet, 2), "inpaint": _inpainter(kind)})
    variables = pair_flax(model, kind)
    batch = make_batch(with_flow=True)
    with jax.enable_x64(True):
        cast = functools.partial(jax.tree_util.tree_map, lambda a: jnp.asarray(a, jnp.float64))
        tx = recording(jsteps.make_two_stage_gc_optimizer(LR, INPAINT_LR, UNFREEZE))
        jstate = JTrainState.create(apply_fn=None, params=cast(variables["params"]), tx=tx,
                                    batch_stats=cast(variables["batch_stats"]))
        jtrain, _ = jsteps.make_two_stage_gc_step(
            HPARAMS, jocc.SimpleOcclusionNet().apply, INPAINTERS[kind][2]())
        jbatch = {k: jnp.asarray(v, jnp.float64) for k, v in batch.items()}
        jax_steps = [(None, None, leaves(jstate.params), leaves(jstate.batch_stats))]
        for _ in range(STEPS):
            jstate, m = jtrain(jstate, jbatch)
            jax_steps.append(({k: float(v) for k, v in m.items()}, leaves(jstate.opt_state[0]),
                              leaves(jstate.params), leaves(jstate.batch_stats)))

    model = model.double()
    state = TrainState(model, make_two_stage_gc_optimizer(model, LR, INPAINT_LR, UNFREEZE))
    state.optimizer.named_params = dict(model.named_parameters())
    grads = []
    snap_grads(state.optimizer, grads)
    train_step, _ = make_two_stage_gc_step(HPARAMS)
    tbatch = {k: torch.from_numpy(v).double() for k, v in batch.items()}
    flat = pair_flax(model, kind)
    port_steps = [(None, None, leaves(flat["params"]), leaves(flat["batch_stats"]))]
    for i in range(STEPS):
        state, m = train_step(state, tbatch)
        flat = pair_flax(model, kind)
        port_steps.append(({k: v.item() for k, v in m.items()},
                           leaves(pair_flax(model, kind, grads[i])["params"]),
                           leaves(flat["params"]), leaves(flat["batch_stats"])))
    return model, state, port_steps, jax_steps


def _part(tree, name):
    return {k: v for k, v in tree.items() if k.startswith(f"['{name}']")}


@pytest.mark.parametrize("kind", ["simple", "gated"])
def test_two_stage_gc_step_and_gate_match_jax(kind):
    model, state, port_steps, jax_steps = run(kind)
    seeded_inp = _part(port_steps[0][2], "inpaint")
    for i in range(1, STEPS + 1):
        (m, g, p, st), (jm, jg, jp, jst) = port_steps[i], jax_steps[i]
        assert set(m) == set(jm) == {"loss", "photometric", "photometric_occluded", "reconst",
                                     "smoothness", "pixelwise", "bce_loss"}
        rel = max(abs(m[k] - v) / abs(v) for k, v in jm.items())
        assert rel <= METRIC_REL, (i, m, jm)
        for name in ("occ", "inpaint"):
            got, want = _part(g, name), _part(jg, name)
            scale = max(np.abs(w).max() for w in want.values())
            gap = max(np.abs(got[k] - w).max() for k, w in want.items()) / scale
            print(f"{kind} step {i - 1} {name}: gradients {gap:.3e} of the net's max|grad|")
            if i <= 2:
                hold_tensors(f"step {i - 1} {name}", got, want, GRAD_REL)
        for k, w in jst.items():
            assert np.abs(st[k] - w).max() <= STATS_REL * np.abs(w).max(), (i, k)
        frozen = i <= UNFREEZE  # the updates of steps 0 .. UNFREEZE - 1 are gated
        for k, v in seeded_inp.items():
            assert np.array_equal(p[k], v) == frozen, (i, k)
            assert np.array_equal(jp[k], v) == frozen, (i, k)
        moved = [k for k, v in _part(st, "inpaint").items()
                 if not np.array_equal(v, _part(port_steps[i - 1][3], "inpaint")[k])]
        assert moved, f"step {i - 1}: the inpainter's running statistics did not move"
    # the first unfrozen update (step UNFREEZE) against optax's
    before, after = port_steps[UNFREEZE][2], port_steps[UNFREEZE + 1][2]
    jbefore, jafter = jax_steps[UNFREEZE][2], jax_steps[UNFREEZE + 1][2]
    keys = list(_part(after, "inpaint"))
    got = np.concatenate([(after[k] - before[k]).ravel() for k in keys])
    want = np.concatenate([(jafter[k] - jbefore[k]).ravel() for k in keys])
    top = abs(np.abs(got).max() / np.abs(want).max() - 1.0)
    l2 = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"{kind}: the first unfrozen inpainter update, largest step "
          f"{np.abs(got).max():.6e} (optax {np.abs(want).max():.6e}, {top:.3e} apart), "
          f"relative L2 {l2:.3e}")
    assert top <= UPDATE_REL and l2 <= UPDATE_L2
    counts = {int(s["step"]) for s in state.optimizer.state.values()}
    assert counts == {STEPS}
    assert state.optimizer.param_groups[1]["updates"] == STEPS


def test_two_stage_bridge_gives_the_pair_back():
    model = nn.ModuleDict({"occ": seeded(SimpleOcclusionNet, 2), "inpaint": _inpainter("simple")})
    sd = two_stage_from_flax(jax.tree_util.tree_map(np.asarray, pair_flax(model, "simple")))
    own = model.state_dict()
    assert set(sd) == set(own)
    assert all(torch.equal(v, own[k]) for k, v in sd.items() if "num_batches" not in k)


def test_gated_adam_matches_optax():
    """``GatedAdam`` against optax's gated Adam on the same fp64 gradients
    (two groups, the second gated until update 2): the parameters after each
    of 4 updates within 1e-12 of max|param|, the gated group's bit for bit
    until it unfreezes."""
    import optax

    rng = np.random.default_rng(0)
    init = {"occ": rng.normal(size=(3, 4)), "inpaint": rng.normal(size=(5,))}
    grads = [{k: rng.normal(size=v.shape) * 10.0 ** rng.integers(-9, 1, size=v.shape)
              for k, v in init.items()} for _ in range(STEPS)]
    with jax.enable_x64(True):
        tx = jsteps.make_two_stage_gc_optimizer(LR, INPAINT_LR, UNFREEZE)
        params = {k: jnp.asarray(v) for k, v in init.items()}
        opt_state = tx.init(params)
        want = []
        for g in grads:
            upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state,
                                       params)
            params = optax.apply_updates(params, upd)
            want.append({k: np.asarray(v) for k, v in params.items()})
    model = nn.ModuleDict({k: nn.Module() for k in init})
    for k, v in init.items():
        model[k].w = nn.Parameter(torch.from_numpy(v.copy()))
    opt = make_two_stage_gc_optimizer(model, LR, INPAINT_LR, UNFREEZE)
    for i, g in enumerate(grads):
        for k, v in g.items():
            model[k].w.grad = torch.from_numpy(v.copy())
        opt.step()
        for k, w in want[i].items():
            got = model[k].w.detach().numpy()
            assert np.abs(got - w).max() <= 1e-12 * np.abs(w).max(), (i, k)
        assert np.array_equal(model["inpaint"].w.detach().numpy(), init["inpaint"]) == \
            (i < UNFREEZE)
