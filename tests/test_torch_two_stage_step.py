"""The TwoStageModel step of the port (``train.steps_two_stage.
make_two_stage_step``) against ``ocflow_tpu.train.steps_two_stage``, on
the CPU at 2x64x64 over 3 Adam steps: a frozen SimpleFlowNet (and the
InpaintingNet the JAX step takes), a trainable SimpleOcclusionNet, seeded
in the port (BatchNorm statistics perturbed) and carried to flax through
the JAX package's converters; a numpy-seeded batch with ``occ``.

In fp64 (both packages, ``jax_enable_x64``), at every step: the loss and
every metric within 1e-5 relative, each occlusion-net gradient within 1e-4
of its max|grad|, the updated running statistics within 1e-5 of max|stat|;
after the steps the parameters within 1e-4 of max|param|. The frozen nets
are unchanged bit for bit, their parameters without gradients. In fp32 the
first step is held: the metrics the same way, the gradient on the whole
(relative L2 within ``FP32_GRAD_L2``; read 2.3e-3, the worst tensor 4.3e-2
of its max|grad|: the occlusion net's train-mode BatchNorms, the deepest
over 8 values a channel, carry fp32 rounding far, while the fp64 steps
agree to 2e-9); the later fp32 steps are printed, not held: Adam's first
update moves every weight by about the learning rate whatever its
gradient's size, so weights whose gradient is rounding noise move apart
(the whole gradient then read 9.4e-2). The port does not run the
reference's unused inpainter forward (dead code under ``jax.jit``) and
takes no inpainter; the eval step's metrics equal the JAX eval step's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ocflow_torch.bench import perturb_batchnorm
from ocflow_torch.models import InpaintingNet, SimpleFlowNet, SimpleOcclusionNet
from ocflow_torch.train import TrainState
from ocflow_torch.train.steps_two_stage import make_two_stage_step
from ocflow_tpu.models import inpainting_net as jinp
from ocflow_tpu.models import occlusion_nets as jocc
from ocflow_tpu.models import simple_flow_net as jsfn
from ocflow_tpu.models import torch_convert as tc
from ocflow_tpu.train import TrainState as JTrainState
from ocflow_tpu.train import steps_two_stage as jsteps
from test_torch_ops import share_cores  # noqa: F401  (autouse)

METRIC_REL, GRAD_REL, STATS_REL, PARAM_REL = 1e-5, 1e-4, 1e-5, 1e-4
FP32_GRAD_L2 = 1e-2
LR = 1e-3
STEPS = 3
HPARAMS = {"smoothness_weight": 0.5, "reconst_weight": 1.0}


def recording(tx):
    """``tx`` behind a transform whose state keeps the last raw gradient
    (``opt_state[0]``)."""
    record = optax.GradientTransformation(
        init=lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        update=lambda grads, state, params=None: (grads, grads))
    return optax.chain(record, tx)


def seeded(cls, seed):
    model = cls(generator=torch.Generator().manual_seed(seed))
    perturb_batchnorm(model, torch.Generator().manual_seed(seed + 100))
    return model


def flax_of(convert, model, grads=None):
    """flax variables of ``model`` through the JAX package's ``convert``;
    with ``grads`` (``{name: tensor}``) the gradients in the parameters'
    places."""
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    sd.update(grads or {})
    return convert(sd)


def make_batch(seed=5, b=2, h=64, w=64, with_flow=False):
    rng = np.random.default_rng(seed)
    batch = {"images": rng.uniform(-1, 1, (b, h, w, 6)).astype(np.float32),
             "occ": (rng.uniform(size=(b, h, w, 1)) > 0.7).astype(np.float32)}
    if with_flow:
        batch["flow"] = (rng.normal(size=(b, h, w, 2)) * 3).astype(np.float32)
    return batch


def leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def per_tensor(got, want):
    assert set(got) == set(want)
    return {k: float(np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-300))
            for k, w in want.items()}


def whole_l2(got, want):
    num = sum(((got[k] - w) ** 2).sum() for k, w in want.items())
    return float((num / sum((w ** 2).sum() for w in want.values())) ** 0.5)


def snap_grads(optimizer, into):
    """Record each step's raw gradients (before the optimizer gates them)."""
    step = optimizer.step

    def wrapped(*a, **k):
        into.append({n: p.grad.clone() for n, p in optimizer.named_params.items()})
        return step(*a, **k)

    optimizer.step = wrapped


def run(fp64):
    """``STEPS`` train steps of both packages, then their eval steps."""
    occ, flow, inp = (seeded(SimpleOcclusionNet, 2), seeded(SimpleFlowNet, 3),
                      seeded(InpaintingNet, 4))
    occ_vars = flax_of(tc.convert_simple_occlusion_net, occ)
    frozen_vars = {"flow": flax_of(tc.convert_simpleflownet, flow),
                   "inpaint": flax_of(tc.convert_inpainting_net, inp)}
    batch = make_batch()
    jdt, dt = (jnp.float64, torch.float64) if fp64 else (jnp.float32, torch.float32)
    with jax.enable_x64(fp64):
        cast = functools.partial(jax.tree_util.tree_map, lambda a: jnp.asarray(a, jdt))
        jstate = JTrainState.create(apply_fn=jocc.SimpleOcclusionNet().apply,
                                    params=cast(occ_vars["params"]),
                                    tx=recording(optax.adam(LR)),
                                    batch_stats=cast(occ_vars["batch_stats"]))
        jtrain, jeval = jsteps.make_two_stage_step(HPARAMS, jsfn.SimpleFlowNet().apply,
                                                   jinp.InpaintingNet().apply)
        jbatch = {k: jnp.asarray(v, jdt) for k, v in batch.items()}
        jfrozen = cast(frozen_vars)
        jax_steps = []
        for _ in range(STEPS):
            jstate, m = jtrain(jstate, jfrozen, jbatch)
            jax_steps.append(({k: float(v) for k, v in m.items()},
                              leaves(jstate.opt_state[0]), leaves(jstate.batch_stats)))
        jeval_m = {k: float(v) for k, v in jeval(jstate, jfrozen, jbatch).items()}
        jparams = leaves(jstate.params)

    occ, flow = occ.to(dt), flow.to(dt)
    frozen = {"flow": flow}
    before = {n: {k: v.clone() for k, v in m.state_dict().items()} for n, m in frozen.items()}
    state = TrainState(occ, torch.optim.Adam(occ.parameters(), lr=LR))
    state.optimizer.named_params = dict(occ.named_parameters())
    grads = []
    snap_grads(state.optimizer, grads)
    train_step, eval_step = make_two_stage_step(HPARAMS)
    tbatch = {k: torch.from_numpy(v).to(dt) for k, v in batch.items()}
    port_steps = []
    for i in range(STEPS):
        state, m = train_step(state, frozen, tbatch)
        stats = leaves(flax_of(tc.convert_simple_occlusion_net, occ)["batch_stats"])
        g = leaves(flax_of(tc.convert_simple_occlusion_net, occ, grads[i])["params"])
        port_steps.append(({k: v.item() for k, v in m.items()}, g, stats))
    eval_m = {k: v.item() for k, v in eval_step(state, frozen, tbatch).items()}
    for n, m in frozen.items():
        assert all(torch.equal(v, m.state_dict()[k]) for k, v in before[n].items()), n
        assert all(p.grad is None for p in m.parameters()), n
    params = leaves(flax_of(tc.convert_simple_occlusion_net, occ)["params"])
    return port_steps, jax_steps, (eval_m, jeval_m), (params, jparams)


@pytest.mark.parametrize("fp64", [True, False], ids=["fp64", "fp32"])
def test_two_stage_step_matches_jax(fp64):
    port_steps, jax_steps, (eval_m, jeval_m), (params, jparams) = run(fp64)
    for i, ((m, g, st), (jm, jg, jst)) in enumerate(zip(port_steps, jax_steps)):
        assert set(m) == set(jm) == {"loss", "photometric", "reconst", "smoothness",
                                     "bce_loss"}
        errs = per_tensor(g, jg)
        worst = max(errs, key=errs.get)
        rel = max(abs(m[k] - v) / abs(v) for k, v in jm.items())
        print(f"{'fp64' if fp64 else 'fp32'} step {i}: metrics {rel:.3e} relative; worst "
              f"gradient {worst} {errs[worst]:.3e} of max|grad|, whole {whole_l2(g, jg):.3e}")
        if not fp64 and i > 0:
            continue
        assert rel <= METRIC_REL, (i, m, jm)
        if fp64:
            assert errs[worst] <= GRAD_REL, (i, worst, errs[worst])
        else:
            assert whole_l2(g, jg) <= FP32_GRAD_L2
        for k, w in jst.items():
            assert np.abs(st[k] - w).max() <= STATS_REL * np.abs(w).max(), (i, k)
    if fp64:
        for k, v in jeval_m.items():
            assert abs(eval_m[k] - v) <= METRIC_REL * abs(v), k
        errs = per_tensor(params, jparams)
        assert max(errs.values()) <= PARAM_REL
