"""The registry against the JAX registry, and ``python -m
ocflow_torch.evaluate`` serving the new keys of the flow and
flow+occlusion families (seeded weights, eval mode) on the CPU."""

import pytest

from test_torch_ops import share_cores  # noqa: F401  (autouse)


def test_registry_equals_the_jax_registry_less_the_a10_families():
    """The port's registry has every key of the JAX registry's flow,
    occlusion and flow+occlusion families and nothing else; the inpainting,
    discriminator and pipeline families are ROADMAP A10."""
    from ocflow_torch.models import available
    from ocflow_tpu.models import registry as jregistry

    want = {f: keys for f, keys in jregistry.available().items()
            if f not in ("inpainting", "discriminator", "pipeline")}
    assert available() == want
    assert set(jregistry.available()) - set(want) == {"inpainting", "discriminator",
                                                      "pipeline"}


@pytest.mark.parametrize("task,key", [("flow", "flownets"), ("flow", "eflownet2"),
                                      ("flow_occ", "simple"), ("flow_occ", "flowoccnets")])
def test_evaluate_serves_the_new_keys(task, key, capsys):
    """``python -m ocflow_torch.evaluate`` serves the new keys (seeded
    weights, eval mode) and prints a finite EPE."""
    import json
    import math

    from ocflow_torch import evaluate as tevaluate

    results = tevaluate.main(["--device", "cpu", "--task", task, "--model", key,
                              "--dataset", "SyntheticFlow", "--dataset_size", "4",
                              "--image_size", "64", "128", "--batch_size", "2"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == results
    assert math.isfinite(results["epe"])
