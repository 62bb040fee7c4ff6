"""``python -m ocflow_torch.train`` against the repository's JAX
``train.py`` on the CPU, at equal weights: SimpleFlowNet with the JAX
package's initial weights (``init`` at ``PRNGKey(seed)``) crossed through
``simpleflownet_from_flax``, the tiny config of
``tests/test_torch_train_cli.py`` (64x128, 20 SyntheticFlow samples, B=4,
2 epochs), learning rate 0 (the train steps then move only the BatchNorm
statistics, whose update is flax's), one device (``mesh_shape: [1]``): the
test metrics within 1e-4 relative, as the other CLIs are held (the
procedural data agree to 1e-4)."""

import importlib.util
import sys

import jax
import jax.numpy as jnp

from ocflow_torch.models import SimpleFlowNet, simpleflownet_from_flax
from ocflow_torch.train import __main__ as cli
from ocflow_tpu.models import simple_flow_net as jsfn
from test_torch_ops import share_cores  # noqa: F401  (autouse)
from test_torch_train_cli import REPO, _config


def test_cli_matches_jax_train_py(tmp_path, capsys, monkeypatch):
    over = {"learning_rate": "0.0", "mesh_shape": "[1]", "log_every_n_steps": 1}
    spec = importlib.util.spec_from_file_location("ocflow_train_cli", REPO / "train.py")
    jtrain = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtrain)
    monkeypatch.setattr(sys, "argv", ["train.py", "--config",
                                      _config(tmp_path, "jax", **over)])
    jtrain.main()
    (line,) = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("test:")]
    ref = eval(line[len("test:"):], {"__builtins__": {}})  # a dict of floats

    variables = jsfn.SimpleFlowNet().init(jax.random.PRNGKey(42), jnp.zeros((1, 64, 128, 6)))
    sd = simpleflownet_from_flax(jax.tree_util.tree_map(lambda a: a.copy(),
                                                        jax.device_get(variables)))

    def build_net(cfg):
        model = SimpleFlowNet()
        model.load_state_dict(sd)
        return model

    monkeypatch.setattr(cli, "build_net", build_net)
    got = cli.main(["--config", _config(tmp_path, "port", **over), "--device", "cpu"])
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert abs(got[k] - float(v)) <= 1e-4 * abs(float(v)), (k, got[k], v)
