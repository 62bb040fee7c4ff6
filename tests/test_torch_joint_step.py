"""The joint flow + occlusion + inpainting step of the port
(``train.steps_joint``) against ``ocflow_tpu.train.steps_joint``, on the
CPU at 2x64x64: FlowOccNetCV (``pwoc``) and InpaintingNet seeded in the port
(BatchNorm statistics perturbed), carried to flax through the JAX package's
converters; a numpy-seeded KITTI-like batch (ground-truth flow valid on
~70% of the pixels, as ``tests/test_bf16_joint.py`` draws it) with ``occ``.
One train step with the gradient recorded (Adam behind); the helpers
serve ``tests/test_torch_joint_step_{fp32,bf16}.py`` too.

In fp64 in both packages: the loss and every metric within 1e-5 relative,
each gradient within 1e-4 of its max|grad| (one zero but for rounding within
1e-12 of its net's max), the running statistics within 1e-5 of max|stat|
(read: metrics 9e-8, gradients 9e-8 of FlowOccNetCV's max|grad|, 3e-12 of
InpaintingNet's). The fp32 and bf16 steps: ``tests/test_torch_joint_step_fp32.py``,
``tests/test_torch_joint_step_bf16.py``.
Six bf16 steps of the port alone lower the loss, keep the master
parameters fp32 and leave the eval step finite. ``masked_flow_l1`` with and
without ``valid``, and the pair's bridge ``joint_from_flax``, are held too.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from torch import nn

from ocflow_torch.models import FlowOccNetCV, InpaintingNet
from ocflow_torch.models.convert import joint_from_flax
from ocflow_torch.train import TrainState
from ocflow_torch.train.steps_joint import make_joint_step, masked_flow_l1
from ocflow_tpu.models import flow_occ_nets as jfon
from ocflow_tpu.models import inpainting_net as jinp
from ocflow_tpu.models import torch_convert as tc
from ocflow_tpu.train import TrainState as JTrainState
from ocflow_tpu.train import steps_joint as jsteps
from test_torch_gan_step import hold_tensors
from test_torch_ops import share_cores  # noqa: F401  (autouse)
from test_torch_two_stage_step import leaves, recording, seeded, snap_grads, whole_l2

METRIC_REL, GRAD_REL, STATS_REL = 1e-5, 1e-4, 1e-5
LR = 1e-4
PARTS = {"flow_occ": tc.convert_flow_occ_net_cv, "inpaint": tc.convert_inpainting_net}


def make_batch(seed=1, b=2, h=64, w=64):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(-1, 1, (b, h, w, 6)).astype(np.float32)
    flow = rng.uniform(-5, 5, (b, h, w, 2)).astype(np.float32)
    valid = (rng.uniform(size=(b, h, w, 1)) > 0.3).astype(np.float32)
    occ = (rng.uniform(size=(b, h, w, 1)) > 0.8).astype(np.float32)
    return {"images": imgs, "flow": flow * valid, "valid": valid, "occ": occ}


def pair_flax(model, grads=None):
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    sd.update(grads or {})
    out = {"params": {}, "batch_stats": {}}
    for name, convert in PARTS.items():
        v = convert({k[len(name) + 1:]: t for k, t in sd.items() if k.startswith(name + ".")})
        out["params"][name] = v["params"]
        out["batch_stats"][name] = v.get("batch_stats", {})
    return out


def _pair(occ_scale=1.0):
    """The seeded pair; FlowOccNetCV's last occlusion head times ``occ_scale``."""
    flow_occ = FlowOccNetCV(generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        flow_occ.predict_occ2[0].weight.mul_(occ_scale)
    return nn.ModuleDict({"flow_occ": flow_occ, "inpaint": seeded(InpaintingNet, 1)})


def run(kind, occ_scale=1.0, size=(2, 64, 64)):
    """One joint train step of both packages in ``kind`` (fp64, fp32,
    bf16) on ``_pair(occ_scale)`` and a batch of ``size`` (B, H, W); the
    metrics, the gradient, the running statistics of each, and the port's
    state and eval step."""
    model = _pair(occ_scale)
    variables = pair_flax(model)
    batch = make_batch(b=size[0], h=size[1], w=size[2])
    fp64 = kind == "fp64"
    jdt, dt = (jnp.float64, torch.float64) if fp64 else (jnp.float32, torch.float32)
    hparams = {"dtype": "bfloat16" if kind == "bf16" else None}
    with jax.enable_x64(fp64):
        cast = functools.partial(jax.tree_util.tree_map, lambda a: jnp.asarray(a, jdt))
        jstate = JTrainState.create(apply_fn=None, params=cast(variables["params"]),
                                    tx=recording(optax.adam(LR)),
                                    batch_stats=cast(variables["batch_stats"]))
        jtrain, _ = jsteps.make_joint_step(hparams, jfon.FlowOccNetCV().apply,
                                           jinp.InpaintingNet().apply)
        jstate, jm = jtrain(jstate, {k: jnp.asarray(v, jdt) for k, v in batch.items()})
        want = ({k: float(v) for k, v in jm.items()}, leaves(jstate.opt_state[0]),
                leaves(jstate.batch_stats))
    model = model.to(dt)
    state = TrainState(model, torch.optim.Adam(model.parameters(), lr=LR))
    state.optimizer.named_params = dict(model.named_parameters())
    grads = []
    snap_grads(state.optimizer, grads)
    train_step, eval_step = make_joint_step(hparams)
    tbatch = {k: torch.from_numpy(v).to(dt) for k, v in batch.items()}
    state, m = train_step(state, tbatch)
    got = ({k: v.item() for k, v in m.items()}, leaves(pair_flax(model, grads[0])["params"]),
           leaves(pair_flax(model)["batch_stats"]))
    return got, want, state, eval_step, tbatch


def port_grads(kind, occ_scale=1.0, size=(2, 64, 64)):
    """The gradient of one joint train step of the port alone in ``kind``
    (fp64 or fp32), in the flax tree's names; the witness of the fp32 and
    bf16 readings (``test_joint_step_fp64_matches_jax`` holds the fp64 step
    to the JAX package's)."""
    dt = torch.float64 if kind == "fp64" else torch.float32
    model = _pair(occ_scale).to(dt)
    state = TrainState(model, torch.optim.Adam(model.parameters(), lr=LR))
    state.optimizer.named_params = dict(model.named_parameters())
    grads = []
    snap_grads(state.optimizer, grads)
    batch = make_batch(b=size[0], h=size[1], w=size[2])
    make_joint_step({})[0](state, {k: torch.from_numpy(v).to(dt) for k, v in batch.items()})
    return leaves(pair_flax(model, grads[0])["params"])


def _part(tree, name):
    """The leaves of ``tree`` under ``name`` (a net, or a path such as
    ``"inpaint']['_Up_5"``)."""
    return {k: v for k, v in tree.items() if k.startswith(f"['{name}']")}


def test_joint_step_fp64_matches_jax():
    (m, g, st), (jm, jg, jst), _, _, _ = run("fp64")
    assert set(m) == set(jm) == {"loss", "flow_l1", "occ_bce", "photometric", "reconst", "epe"}
    rel = max(abs(m[k] - v) / abs(v) for k, v in jm.items())
    print(f"fp64: metrics relative {rel:.3e}; gradient whole {whole_l2(g, jg):.3e}")
    assert rel <= METRIC_REL
    for name in PARTS:
        hold_tensors(name, _part(g, name), _part(jg, name), GRAD_REL)
    for k, w in jst.items():
        assert np.abs(st[k] - w).max() <= STATS_REL * np.abs(w).max(), k


def test_joint_step_bf16_trains():
    model = _pair()
    state = TrainState(model, torch.optim.Adam(model.parameters(), lr=LR))
    batch = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    step, eval_step = make_joint_step({"dtype": "bfloat16"})
    losses = []
    for _ in range(6):
        state, m = step(state, batch)
        losses.append(m["loss"].item())
    print(f"bf16 losses over six steps: {losses}")
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert all(v.dtype == torch.float32 for v in model.state_dict().values()
               if v.is_floating_point())
    assert all(np.isfinite(v.item()) for v in eval_step(state, batch).values())


def test_masked_flow_l1_matches_jax():
    rng = np.random.default_rng(7)
    pred, gt = rng.normal(size=(2, 2, 8, 8, 2)).astype(np.float32)
    valid = (rng.uniform(size=(2, 8, 8, 1)) > 0.4).astype(np.float32)
    for v in (valid, None):
        want = float(jsteps.masked_flow_l1(jnp.asarray(pred), jnp.asarray(gt),
                                           None if v is None else jnp.asarray(v)))
        got = masked_flow_l1(torch.from_numpy(pred), torch.from_numpy(gt),
                             None if v is None else torch.from_numpy(v)).item()
        assert abs(got - want) <= 1e-6 * abs(want)
    # the mask's normalization: sum(|d| valid) / (2 sum(valid) + 1e-8)
    d = np.abs(pred - gt)
    assert np.isclose(masked_flow_l1(torch.from_numpy(pred), torch.from_numpy(gt),
                                     torch.from_numpy(valid)).item(),
                      (d * valid).sum() / (2 * valid.sum() + 1e-8), rtol=1e-6)


def test_joint_bridge_gives_the_pair_back():
    model = _pair()
    sd = joint_from_flax(jax.tree_util.tree_map(np.asarray, pair_flax(model)))
    own = model.state_dict()
    assert set(sd) == set(own)
    assert all(torch.equal(v, own[k]) for k, v in sd.items() if "num_batches" not in k)
