"""``python -m ocflow_torch.train_unsupervised`` on the nets it now trains,
on the CPU: a run against the repository's JAX ``train_unsupervised.py``
at equal weights (the two training CLIs' refusal of EFlowNet and EFlowNet2,
beside the JAX steps' own failure on them, is in
``tests/test_torch_enets.py``).

The run: FlowNetS (``model: flownets``) with the JAX package's initial
weights (``init`` at ``PRNGKey(seed)``, as the JAX CLI draws them) crossed
through ``flownets_from_flax``, the tiny occlusion-aware config of
``tests/test_torch_cli.py`` (64x128, 20 SyntheticFlowWarp samples, B=4, 1
epoch), learning rate 0 (the train steps then move only the BatchNorm
statistics, twice a step: the forward pass and the backward-flow pass),
one device (``mesh_shape: [1]``): the test metrics within 1e-4 relative,
as the other CLIs are held (the procedural data agree to 1e-4).
"""

import importlib.util
import sys

import jax
import jax.numpy as jnp
import numpy as np

from ocflow_torch import train_unsupervised as ucli
from ocflow_torch.models import FlowNetS, flownets_from_flax
from ocflow_tpu.models import flow_net_s as jfns
from test_torch_cli import REPO, _tiny_config
from test_torch_ops import share_cores  # noqa: F401  (autouse)


def test_cli_matches_jax_train_unsupervised_py(tmp_path, capsys, monkeypatch):
    over = {"model": "flownets", "learning_rate": "0.0", "mesh_shape": "[1]", "seed": 42}
    spec = importlib.util.spec_from_file_location("ocflow_unsup_cli",
                                                  REPO / "train_unsupervised.py")
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)
    (tmp_path / "jax").mkdir()
    monkeypatch.setattr(sys, "argv", ["train_unsupervised.py", "--config",
                                      _tiny_config(tmp_path / "jax", **over)])
    jcli.main()
    (line,) = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("test:")]
    ref = eval(line[len("test:"):], {"__builtins__": {}})  # a dict of floats

    variables = jfns.FlowNetS().init(jax.random.PRNGKey(42), jnp.zeros((1, 64, 128, 6)))
    sd = flownets_from_flax(jax.tree_util.tree_map(lambda a: np.array(a),
                                                   jax.device_get(variables)))

    def build_net(cfg):
        assert cfg.model == "flownets" and cfg.seed == 42
        model = FlowNetS()
        model.load_state_dict(sd)
        return model

    monkeypatch.setattr(ucli, "build_net", build_net)
    (tmp_path / "port").mkdir()
    got = ucli.main(["--config", _tiny_config(tmp_path / "port", **over), "--device", "cpu"])
    assert set(got) == set(ref) and "photometric_occ" in got
    for k, v in ref.items():
        assert abs(got[k] - float(v)) <= 1e-4 * abs(float(v)), (k, got[k], v)
