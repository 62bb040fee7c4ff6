"""One occlusion-aware unsupervised train step of the port == one step of
``ocflow_tpu``'s ``make_unsupervised_flow_step`` on the nets with BatchNorm
or a d=4 / d=10 cost volume that the unsupervised CLI now trains: FlowNetS
and FlowNetC here, FlowNet and PWCNet in
``tests/test_torch_unsup_flownet.py`` and ``tests/test_torch_unsup_pwcnet.py``
(one JAX step there takes 20-25 s to compile and run on this CPU); the
step's two repairs.

Set-up: ``configs/longrun_synthetic.yaml``'s hparams (occlusion-aware,
range map, photo 4.0, smooth1 0.5, smooth2 0.0) in fp32, the seeded init
of each net (BatchNorm at the identity, biases zero), crossed to flax
through the JAX package's converters; a batch of 2x64x128 smooth frames
(``tests/test_torch_step.py:smooth_batch``). The JAX state's optimizer
hands back the raw gradient (``CAPTURE``). Both steps run the forward and
the stop-gradient backward-flow pass in train mode: BatchNorm normalizes by
each pass's batch, and the second pass starts from the statistics the
first one updated.

Bounds: every metric within 1e-5 relative (measured at most 5.4e-6 over
the four nets and seeds 0-2); every running statistic after the step
within 1e-5 of max|statistic| (measured at most 5.3e-6); each gradient,
max-abs over its max|grad|, within ``GRAD_REL`` and the median over the
net's tensors within ``GRAD_MEDIAN``, each just above the reading at the
tests' seed 0 (weights seed 0, batch seed 1). A bias that reaches the loss
only through a train-mode BatchNorm (FPNUp's deconv in FlowNet) has a zero
gradient in exact arithmetic and is held against the net's largest
gradient. Where a bound exceeds 1e-4 the test also runs the port's step in
fp64 (``model.double()``) as the witness, and holds the two packages' fp32
gradients at the same distance from it (``check_witness``: the port's
largest and median per-tensor distance at most 1.25 times the JAX
package's, plus 1e-4 and 1e-5).

Readings, the largest per-tensor error port-vs-JAX (its port-vs-fp64 |
JAX-vs-fp64), then the median port-vs-JAX, at seeds 0 | 1 | 2:

- FlowNetS: 6.7e-5 | 7.4e-5 | 6.9e-5 (every tensor within 7.1e-5 of fp64
  on both sides), medians 2.3e-6-6.1e-6: bounds 1e-4 and 5e-6;
- FlowNetC: 3.5e-4 (4.3e-6 | 3.5e-4) | 3.7e-5 | 1.6e-2 (1.3e-6 | 1.6e-2),
  the JAX package's fp32 rounding on the encoder's conv2; medians
  2.3e-6-6.6e-6: bounds 5e-4 and 1e-5;
- FlowNet: 9.0e-3 (5.5e-7 | 9.0e-3, the context network's ConvBlock_3, as
  `tests/test_torch_supervised_steps.py` found on this net) | 1.5e-2 (3.5e-6 | 1.5e-2) |
  2.9e-1 (2.9e-1 | 1.0e-4, FPNUp_0's kernel, whose max|grad| is 1 % of the
  net's largest); medians 2.1e-4 | 3.1e-5 | 1.5e-5: bounds 1e-2 and 3e-4.
  Its deep train-mode BatchNorms over few values (4-16 a channel at the
  pyramid's top) carry the fp32 forward about 5e-6 from fp64, and a
  LeakyReLU whose normalized input lies that close to 0 takes its slope
  from rounding: at seed 0 both packages' largest distance from the fp64
  step is 7e-2 (the estimators' first blocks), at seed 2 the port's;
- PWCNet: 1.8e-6 | 7.6e-6 | 3.0e-6, medians 8.7e-7-1.3e-6 (no BatchNorm):
  bounds 1e-4 and 2e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ocflow_torch.models import FlowNet, FlowNetC, FlowNetS, PWCNet
from ocflow_torch.train import TrainState, create_train_state, make_unsupervised_flow_step
from ocflow_tpu.models import flow_net as jfn
from ocflow_tpu.models import flow_net_s as jfns
from ocflow_tpu.models import pwc_net as jpwc
from ocflow_tpu.models import torch_convert as tc
from ocflow_tpu.train import TrainState as JTrainState
from ocflow_tpu.train import steps as jsteps
from test_torch_ops import share_cores  # noqa: F401  (autouse)
from test_torch_step import smooth_batch
from test_torch_zoo_nets import to_flax

# configs/longrun_synthetic.yaml's step hparams, in fp32
HP = {"occ_aware": True, "occ_method": "range_map", "occ_resolution": "full",
      "photo_weight": 4.0, "smooth1_weight": 0.5, "smooth2_weight": 0.0,
      "fast_forward": "both", "compute_dtype": "float32"}
CASES = {"flownets": (FlowNetS, jfns.FlowNetS, tc.convert_flownets),
         "flownetc": (FlowNetC, jfns.FlowNetC, tc.convert_flownetc),
         "flownet": (FlowNet, jfn.FlowNet, tc.convert_flownet_fpn),
         "pwcnet": (PWCNet, jpwc.PWCNet, tc.convert_flownetcv)}
GRAD_REL = {"flownets": 1e-4, "flownetc": 5e-4, "flownet": 1e-2, "pwcnet": 1e-4}
GRAD_MEDIAN = {"flownets": 5e-6, "flownetc": 1e-5, "flownet": 3e-4, "pwcnet": 2e-6}
# check_witness: the port's distance from the fp64 step over the JAX
# package's, and the slack on the largest and the median
WITNESS_RATIO, WITNESS_SLACK, WITNESS_MEDIAN_SLACK = 1.25, 1e-4, 1e-5

# the JAX optimizer: its state becomes the raw gradient, the params stay
CAPTURE = optax.GradientTransformation(
    init=lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
    update=lambda grads, state, params=None: (
        jax.tree_util.tree_map(jnp.zeros_like, grads), grads))


def _flax(key, model, grads=False):
    """flax variables of ``model`` (fp32 copies; with ``grads`` its
    gradients in place of its parameters)."""
    sd = {k: v.detach().float().clone() for k, v in model.state_dict().items()}
    if grads:
        sd.update({k: p.grad.float().clone() for k, p in model.named_parameters()})
    port_cls, _, convert = CASES[key]
    return to_flax(port_cls, convert, sd)


def run_steps(key, seed=0, fp64_witness=False, hp=None):
    """One step of both packages from the seeded init of ``key`` on
    :func:`smooth_batch` (seed ``seed + 1``); with ``fp64_witness`` also
    the port's step in fp64 on the same weights. Returns a dict."""
    port_cls, jax_cls, _ = CASES[key]
    hp = {**HP, "model": key, **(hp or {})}
    model = port_cls(generator=torch.Generator().manual_seed(seed))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    variables = _flax(key, model)
    batch = smooth_batch(seed + 1)
    jstate = JTrainState.create(apply_fn=jax_cls().apply, params=variables["params"],
                                tx=CAPTURE, batch_stats=variables.get("batch_stats") or {})
    jtrain, _ = jsteps.make_unsupervised_flow_step(hp)
    jstate, jmetrics = jtrain(jstate, {k: jnp.asarray(v) for k, v in batch.items()})

    state = create_train_state(model, 1e-4, device="cpu")
    train_step, eval_step = make_unsupervised_flow_step(hp)
    state, metrics = train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert state.model.training and state.step == 1
    out = {"model": model, "state": state, "metrics": metrics, "jstate": jstate,
           "jmetrics": jmetrics, "eval_step": eval_step, "batch": batch}
    if fp64_witness:
        m64 = port_cls()
        m64.load_state_dict(init)
        m64 = m64.double()
        step64, _ = make_unsupervised_flow_step(hp)
        step64(TrainState(m64, torch.optim.Adam(m64.parameters(), lr=1e-4)),
               {k: torch.from_numpy(v).double() for k, v in batch.items()})
        out["model64"] = m64
    return out


def _bn_fed(name):
    """FPNUp's deconv bias: it reaches the loss only through a train-mode
    BatchNorm (zero gradient in exact arithmetic)."""
    return "FPNUp" in name and name.endswith("['ConvTranspose_0']['bias']")


def grad_errors(key, run):
    """Per flax parameter path: ``(port vs JAX, port vs fp64, JAX vs
    fp64)`` max-abs errors over the tensor's max|grad| (a :func:`_bn_fed`
    bias over the net's largest); the fp64 readings are None without the
    witness."""
    got = dict(jax.tree_util.tree_leaves_with_path(_flax(key, run["model"], True)["params"]))
    g64 = None
    if "model64" in run:
        g64 = dict(jax.tree_util.tree_leaves_with_path(
            _flax(key, run["model64"], True)["params"]))
    want = [(p, np.asarray(w, np.float64))
            for p, w in jax.tree_util.tree_leaves_with_path(run["jstate"].opt_state)]
    assert len(got) == len(want)
    top = max(float(np.abs(w).max()) for _, w in want)
    errs = {}
    for path, w in want:
        name = jax.tree_util.keystr(path)
        scale = top if _bn_fed(name) else np.abs(w).max()
        a = np.asarray(got[path], np.float64)
        row = [np.abs(a - w).max() / scale, None, None]
        if g64 is not None:
            b = np.asarray(g64[path], np.float64)
            row[1:] = np.abs(a - b).max() / scale, np.abs(w - b).max() / scale
        errs[name] = tuple(row)
    return errs


def check_step(key):
    """The step of ``key`` against the JAX step, as the module docstring
    states."""
    witness = GRAD_REL[key] > 1e-4
    run = run_steps(key, fp64_witness=witness)
    metrics, jmetrics = run["metrics"], run["jmetrics"]
    assert set(metrics) == set(jmetrics) and "photometric_occ" in metrics
    for k, v in jmetrics.items():
        assert abs(metrics[k].item() - float(v)) <= 1e-5 * abs(float(v)), k

    errs = grad_errors(key, run)
    pj = {k: e[0] for k, e in errs.items()}
    worst = max(pj, key=pj.get)
    assert pj[worst] <= GRAD_REL[key], (worst, errs[worst])
    assert np.median(list(pj.values())) <= GRAD_MEDIAN[key]
    if witness:
        check_witness(errs)

    jstats = run["jstate"].batch_stats
    if jstats:
        have = dict(jax.tree_util.tree_leaves_with_path(_flax(key, run["model"])["batch_stats"]))
        leaves = jax.tree_util.tree_leaves_with_path(jstats)
        assert len(leaves) == len(have) > 0
        for path, w in leaves:
            w = np.asarray(w)
            assert np.abs(have[path] - w).max() <= 1e-5 * np.abs(w).max(), path
            # both passes moved the statistics from the identity
            assert not np.allclose(w, 1.0 if path[-1].key == "var" else 0.0)

    # the eval step: eval mode, the running statistics, no update
    model, before = run["model"], {k: v.clone() for k, v in run["model"].state_dict().items()}
    out = run["eval_step"](run["state"], {k: torch.from_numpy(v)
                                          for k, v in run["batch"].items()})
    assert not model.training and set(out) == set(metrics)
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in before.items())


def check_witness(errs):
    """The two packages' fp32 gradients lie at the same distance from the
    port's fp64 step: the port's largest and median per-tensor distance at
    most WITNESS_RATIO times the JAX package's, plus the slack."""
    p64 = [e[1] for e in errs.values()]
    j64 = [e[2] for e in errs.values()]
    assert max(p64) <= WITNESS_RATIO * max(j64) + WITNESS_SLACK, (max(p64), max(j64))
    assert np.median(p64) <= WITNESS_RATIO * np.median(j64) + WITNESS_MEDIAN_SLACK


@pytest.mark.parametrize("key", ["flownets", "flownetc"])
def test_unsupervised_step_matches_jax(key):
    check_step(key)


def test_step_convolutions_run_without_tf32_under_bf16(monkeypatch):
    """``compute_dtype: bfloat16`` on a net other than FlowNetCV: the JAX
    step runs the net in fp32 and casts only the loss tail's images, so the
    port's step runs the forward, the backward-flow pass and
    ``loss.backward()`` with cuDNN's TF32 off, whatever the caller's flag,
    and gives the flag back; the loss tail's images are bf16."""
    seen = {"forward": [], "backward": []}
    conv2d = torch.nn.functional.conv2d

    def spy(*args, **kwargs):
        seen["forward"].append(torch.backends.cudnn.allow_tf32)
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    model = FlowNetC(generator=torch.Generator().manual_seed(0))
    model.conv1[0].weight.register_hook(
        lambda g: seen["backward"].append(torch.backends.cudnn.allow_tf32))
    tail = []
    import ocflow_torch.train.steps as steps_mod
    photometric = steps_mod.losses.photometric_error

    def photo_spy(img_warped, img1, occ=None):
        tail.append(img1.dtype)
        return photometric(img_warped, img1, occ)

    monkeypatch.setattr(steps_mod.losses, "photometric_error", photo_spy)
    state = create_train_state(model, 1e-4, device="cpu")
    train_step, _ = make_unsupervised_flow_step(
        {**HP, "model": "flownetc", "compute_dtype": "bfloat16"})
    batch = smooth_batch(1)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        # the forward pass and the backward-flow pass: 2 x 13 convs
        assert len(seen["forward"]) >= 26 and not any(seen["forward"])
        assert seen["backward"] and not any(seen["backward"])
        assert torch.backends.cudnn.allow_tf32
        assert tail and set(tail) == {torch.bfloat16}
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def test_viz_fn_leaves_the_running_statistics_alone():
    """The unsupervised CLI's panels apply the net in eval mode, as the JAX
    panels apply it with ``train=False``: a FlowNetC's running statistics
    are the same after ``viz_fn``, and the model is back in the mode it was
    in."""
    from ocflow_torch.train_unsupervised import viz_fn

    model = FlowNetC(generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, 1e-4, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in smooth_batch(1).items()}
    for training in (True, False):
        model.train(training)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        panels = viz_fn(state, batch)
        assert set(panels) == {"warp", "flow"}
        assert model.training == training
        assert all(torch.equal(v, model.state_dict()[k]) for k, v in before.items())
