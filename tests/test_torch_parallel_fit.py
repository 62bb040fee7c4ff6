"""``fit`` over 2 gloo ranks (``tests/torch_parallel_ranks.py:fit_rank``) ==
the JAX package's ``fit`` on ``make_mesh((2,))``, on the CPU.

The net is PWCNet (``model: pwcnet``: FlowNetCV's structure with a raw
correlation and no BatchNorm, so a sample's flow does not depend on the
rest of its batch, and the JAX package's global-batch flax forward equals
the port's forward per block), seeded from 0 on both sides;
``tests/test_torch_loop.py``'s fit otherwise: 16 SyntheticFlowWarp samples
at 64x128 (12 / 1 / 3), a global batch of 4 (2 a rank), the device cache,
2 epochs, every step logged, learning rate 1e-6. The val batch of one
sample is padded to two by repeating it, on both sides. Held: the CSVs'
rows and columns equal (only rank 0 writes one), each metric within
``test_fit_matches_jax_fit``'s bound at this learning rate (4e-3 relative;
read 3.5e-6, train ``smooth2`` at step 5),
the same epoch saved as best, both ranks' loaders split the global batch,
their steps and parameters equal after the run.
"""

from concurrent.futures import ThreadPoolExecutor

import optax
import pytest
import torch

import torch_parallel_ranks as ranks
from ocflow_torch.models import PWCNet
from ocflow_torch.tools.dryrun_multigpu import spawn
from ocflow_torch.utils import checkpoint as tckpt
from ocflow_tpu.models import pwc_net as jpwc
from ocflow_tpu.models.torch_convert import convert_flownetcv
from ocflow_tpu.parallel.mesh import make_mesh
from ocflow_tpu.train import TrainState as JTrainState
from ocflow_tpu.train import config as jconfig
from ocflow_tpu.train import loop as jloop
from ocflow_tpu.train import steps as jsteps
from ocflow_tpu.utils import checkpoint as jckpt
from test_torch_loop import FIT, FIT_REL, _outputs, _read_csv
from test_torch_ops import share_cores  # noqa: F401  (autouse)

WORLD = 2
LR = 1e-6
RAW = {**FIT, "model": "pwcnet", "learning_rate": LR}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX fit here while the ranks run theirs."""
    tmp = tmp_path_factory.mktemp("fit")
    port = _outputs(tmp, "port")
    with ThreadPoolExecutor(1) as pool:
        ranks_done = pool.submit(spawn, ranks.fit_rank, WORLD, str(tmp), {**RAW, **port},
                                 timeout=300)
        jcfg = _jax_fit(tmp)
        ranks_done.result()
    per_rank = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"jax": jcfg, "port": port, "ranks": per_rank}


def _jax_fit(tmp):
    jcfg = jconfig.config_from_dict({**RAW, **_outputs(tmp, "jax")})
    jtrain, jval, _ = jloop.make_loaders(jcfg)
    model = PWCNet(generator=torch.Generator().manual_seed(0))
    jstate = JTrainState.create(apply_fn=jpwc.PWCNet().apply,
                                params=convert_flownetcv(model.state_dict())["params"],
                                tx=optax.adam(LR))
    jtrain_step, jeval_step = jsteps.make_unsupervised_flow_step(jcfg.as_hparams())
    jloop.fit(jcfg, jstate, jtrain_step, jeval_step, jtrain, jval, mesh=make_mesh((WORLD,)))
    return jcfg


def test_fit_csv_matches_jax_fit_on_two_devices(runs):
    port, ref = _read_csv(runs["port"]["metrics_csv"]), _read_csv(runs["jax"].metrics_csv)
    assert list(port[0]) == list(ref[0])
    assert [(r["phase"], r["step"], r["epoch"]) for r in port] == \
        [(r["phase"], r["step"], r["epoch"]) for r in ref]
    assert [r["phase"] for r in port].count("train") == 6
    drift = {}
    for p, r in zip(port, ref):
        for k in r:
            if k in ("phase", "step", "epoch", "images_per_sec") or r[k] == "":
                continue
            drift[(p["phase"], p["step"], k)] = abs(float(p[k]) - float(r[k])) / abs(float(r[k]))
    worst = max(drift, key=drift.get)
    assert drift[worst] <= FIT_REL[LR], (worst, drift[worst])


def test_fit_saves_the_same_best_epoch(runs):
    assert tckpt.CheckpointManager(runs["port"]["checkpoint_dir"]).best_step == \
        jckpt.CheckpointManager(runs["jax"].checkpoint_dir).best_step


def test_ranks_load_their_blocks_and_end_equal(runs):
    first, *rest = runs["ranks"]
    for r, res in enumerate(runs["ranks"]):
        assert res["blocks"] == ((r, WORLD), (r, WORLD)) and res["step"] == 6
    for other in rest:
        assert all(torch.equal(other["params"][n], p) for n, p in first["params"].items())
