"""The SN-PatchGAN step over 2 gloo ranks, fp64, against the JAX package's
step on the whole batch under ``jax_enable_x64``
(``tests/torch_parallel_ranks.py:gan_case``): the projected gated generator
with remat (its recompute re-runs the synced BatchNorms' collectives in the
backward pass; ``gamma`` 0.5, BatchNorms perturbed) and the projected
discriminator (its train forward on each rank's ``[pos block; neg block]``
synced, its eval forward not), both seeded in the port and carried to flax;
two samples at 64x128, one a rank, the hole over 50% and 20%; SGD at 0.05
for both nets. Held at ``tests/test_torch_gan_step.py``'s bounds (1e-9):
every metric (relative), each gradient of G and of D summed over the ranks
(of its tensor's max|grad|; the tensors that are zero but for rounding held
in absolute terms, as there), G's running statistics and D's ``u`` and
``sigma`` after the step; both ranks' metrics and nets equal bit for bit.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import pytest

import torch_parallel_ranks as ranks
from ocflow_torch.tools.dryrun_multigpu import spawn
from ocflow_tpu.models import gated_conv as jg
from ocflow_tpu.models import torch_convert as tc
from ocflow_tpu.train import TrainState as JTrainState
from ocflow_tpu.train import steps_inpainting as jsteps
from test_torch_gan_step import (REL, capture_sgd, dis_to_flax, gen_flax, hold_tensors, leaves,
                                 per_tensor)
from test_torch_ops import share_cores  # noqa: F401  (autouse)

WORLD = 2


def _jax_step():
    gen, dis = ranks.gan_nets()
    gv = tc.convert_inpaint_sanet({k: v.clone() for k, v in gen.state_dict().items()},
                                  projected=True)
    dparams, dstats = dis_to_flax(dis.state_dict(), projected=True)
    with jax.enable_x64(True):
        cast = functools.partial(jax.tree_util.tree_map, lambda a: jnp.asarray(a, jnp.float64))
        jgen = JTrainState.create(apply_fn=jg.InpaintSANet().apply, params=cast(gv["params"]),
                                  tx=capture_sgd(ranks.GAN_LR),
                                  batch_stats=cast(gv["batch_stats"]))
        jdis = JTrainState.create(apply_fn=jg.InpaintSADiscriminator().apply,
                                  params=cast(dparams), tx=capture_sgd(ranks.GAN_LR),
                                  batch_stats=cast(dstats))
        step = jsteps.make_gan_inpainting_step({"loss_type": "pixel-wise"})
        jgen, jdis, jm = step(jgen, jdis, {k: jnp.asarray(v, jnp.float64)
                                           for k, v in ranks.gan_batch().items()})
        return {k: float(v) for k, v in jm.items()}, jgen, jdis


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gan")
    with ThreadPoolExecutor(1) as pool:
        done = pool.submit(spawn, ranks.sync_rank, WORLD, str(tmp), ["gan"], timeout=300)
        want = _jax_step()
        done.result()
    return [res["gan"] for res in ranks.load_ranks(tmp, WORLD)], want


def test_gan_step_over_two_ranks_matches_jax(run):
    got, (jm, jgen, jdis) = run
    first = got[0]
    for other in got[1:]:
        assert other["metrics"] == first["metrics"]
    assert ranks.same_nets(got, "gen") and ranks.same_nets(got, "dis")
    assert set(first["metrics"]) == set(jm)
    for k, v in jm.items():
        assert abs(first["metrics"][k] - v) <= REL * abs(v), (k, first["metrics"][k], v)
    gen, _ = ranks.gan_nets()
    gen = gen.double()
    for n, p in gen.named_parameters():
        p.grad = first["grads"]["gen"][n]
    zero = hold_tensors("G", leaves(gen_flax(gen, grads=True)["params"]),
                        leaves(jgen.opt_state))
    assert all("bias" in k for k in zero)
    hold_tensors("D", leaves(dis_to_flax(first["grads"]["dis"], True)[0]),
                 leaves(jdis.opt_state))
    gen.load_state_dict(first["gen"])
    for what, have, want in (("G statistics", gen_flax(gen)["batch_stats"], jgen.batch_stats),
                             ("D u, sigma", dis_to_flax(first["dis"], True)[1],
                              jdis.batch_stats)):
        errs = per_tensor(leaves(have), leaves(want))
        worst = max(errs, key=errs.get)
        assert errs[worst] <= REL, (what, worst, errs[worst])
