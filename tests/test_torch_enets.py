"""EFlowNet and EFlowNet2 (``eflownet``, ``eflownet2``) == the JAX modules,
at equal weights on the CPU, and their weight bridge: the checks and bounds
of ``tests/test_torch_zoo_nets.py`` (whose docstring states them, the
train-mode forward against the flax module in fp64 included), the channel
dropout in train mode, the PReLU slopes of the seeded init, and the two
training CLIs' refusal of both nets beside the JAX steps' own failure on
them."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.errors import InvalidRngError

from ocflow_torch import train_unsupervised as ucli
from ocflow_torch.train import __main__ as scli
from ocflow_tpu.models import efficient_flow_net as jefn
from ocflow_tpu.train import TrainState as JTrainState
from ocflow_tpu.train import steps as jsteps
from test_torch_cli import _tiny_config
from test_torch_ops import share_cores  # noqa: F401  (autouse)
from test_torch_train_cli import _config as _supervised_config
from test_torch_zoo_nets import ENETS, NETS, check_forward, check_round_trip, check_train_mode


@pytest.mark.parametrize("key", ENETS)
def test_forward_matches_jax(key):
    check_forward(key)


@pytest.mark.parametrize("key", ENETS)
def test_train_mode_forward_and_batch_stats_match_jax(key):
    check_train_mode(key)


@pytest.mark.parametrize("key", ENETS)
def test_from_flax_round_trip(key):
    check_round_trip(key)


@pytest.mark.parametrize("key", ENETS)
def test_enet_dropout_drops_whole_channels_in_train_mode(key):
    """Each bottleneck's dropout zeroes whole (sample, channel) maps and
    scales the rest by 1 / (1 - p), as flax's ``Dropout(broadcast_dims=(1,
    2))``; eval mode is the identity."""
    model = NETS[key][0](generator=torch.Generator().manual_seed(0))
    drops = [m for m in model.modules() if isinstance(m, torch.nn.Dropout2d)]
    assert len(drops) == 5 + 1 + 16 + 5 and {d.p for d in drops} == {0.01, 0.1}
    x = torch.rand(4, 8, 6, 5) + 0.5
    d = drops[-1].train()
    torch.manual_seed(0)
    y = d(x)
    kept = (y != 0).flatten(2)
    assert torch.equal(kept.all(-1), kept.any(-1))  # whole maps
    assert not kept.all()
    torch.testing.assert_close(y[y != 0], (x / (1 - d.p))[y != 0])
    assert torch.equal(d.eval()(x), x)


@pytest.mark.parametrize("key", ENETS)
def test_enet_prelu_slopes_after_seeded_init_are_flax(key):
    """The initial block's 16 slopes start at 0.25, every bottleneck PReLU
    is one slope at flax's 0.01, and there are as many as in the flax
    module's tree, leaf for leaf."""
    port_cls, jax_cls, convert, _ = NETS[key]
    model = port_cls(generator=torch.Generator().manual_seed(0))
    slopes = {n: p for n, p in model.named_parameters() if "prelu" in n or n.endswith("2.2.weight")}
    assert torch.equal(slopes.pop("initial.prelu.weight"), torch.full((16,), 0.25))
    assert all(p.shape == (1,) and p.item() == np.float32(0.01) for p in slopes.values())
    # the flax tree's slopes: where they are, from the init's shapes; their
    # values, from the inits of the two flax modules they come from
    shapes = jax.eval_shape(jax_cls().init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 6)))
    scalar = fnn.PReLU().init(jax.random.PRNGKey(0), jnp.zeros(3))["params"]
    channel = jefn.ChannelPReLU().init(jax.random.PRNGKey(0), jnp.zeros((1, 16)))["params"]
    ref = {jax.tree_util.keystr(p): np.asarray(
        (channel if "ChannelPReLU" in str(p) else scalar)["negative_slope"])
        for p, _ in jax.tree_util.tree_leaves_with_path(shapes["params"]) if "PReLU" in str(p)}
    got = {jax.tree_util.keystr(p): np.asarray(v) for p, v in jax.tree_util.tree_leaves_with_path(
        convert(model.state_dict())["params"]) if "PReLU" in str(p)}
    assert len(got) == len(ref) == len(slopes) + 1
    for path, v in ref.items():
        np.testing.assert_array_equal(got[path], v)


@pytest.mark.parametrize("key", ENETS)
def test_training_clis_refuse_the_enets_as_the_jax_steps_fail_on_them(tmp_path, key):
    """Both training CLIs refuse EFlowNet and EFlowNet2, saying why: the JAX
    steps pass no dropout rng, and flax raises ``InvalidRngError`` on the
    first train step of either net, unsupervised and supervised (if the
    reference learns to train them, this test fails and the refusal is to
    be revisited)."""
    with pytest.raises(NotImplementedError, match="dropout rng"):
        ucli.main(["--config", _tiny_config(tmp_path, model=key), "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="dropout rng"):
        scli.main(["--config", _supervised_config(tmp_path, model=key), "--device", "cpu"])

    rng = np.random.default_rng(0)
    batch = {"images": jnp.asarray(rng.uniform(-1, 1, (2, 32, 32, 6)), jnp.float32),
             "flow": jnp.zeros((2, 32, 32, 2))}
    net = NETS[key][1]()
    # the step fails while it is traced, whatever the weights: zeros of the
    # init's shapes
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), batch["images"][:1])
    variables = jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype), shapes)
    for factory, hp in ((jsteps.make_unsupervised_flow_step, {"model": key}),
                        (jsteps.make_supervised_flow_step, {})):
        state = JTrainState.create(apply_fn=net.apply, params=variables["params"],
                                   batch_stats=variables["batch_stats"], tx=optax.adam(1e-4))
        train_step, _ = factory(hp)
        with pytest.raises(InvalidRngError, match="dropout"):
            train_step(state, batch)
    # serving works in both packages (eval mode: dropout is the identity)
    net.apply(variables, batch["images"], train=False)
    with torch.no_grad():
        out = NETS[key][0]().eval()(torch.from_numpy(np.array(batch["images"])))
    assert out.shape == (2, 32, 32, 2)
