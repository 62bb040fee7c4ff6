"""The registry against the JAX registry, and ``python -m
ocflow_torch.evaluate`` serving the keys of the flow and flow+occlusion
families added with the zoo (seeded weights, eval mode) on the CPU."""

import pytest

from test_torch_ops import share_cores  # noqa: F401  (autouse)


def test_registry_equals_the_jax_registry_less_the_a10_families():
    """The port's registry has every key of the JAX registry: since A10.3
    the gated-conv generators (``inpainting/gated``, ``gated_org``) and the
    ``discriminator`` family too, each built as the JAX registry's class of
    the same name."""
    from ocflow_torch.models import available, build
    from ocflow_tpu.models import registry as jregistry

    want = {f: sorted(keys) for f, keys in jregistry.available().items()}
    assert available() == want
    assert want["inpainting"] == ["gated", "gated_org", "simple"]
    assert want["discriminator"] == ["gated", "gated_org"]
    for family in ("inpainting", "discriminator"):
        for key in want[family]:
            assert type(build(family, key)).__name__ == type(jregistry.build(family, key)).__name__


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
