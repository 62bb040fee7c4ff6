"""``parallel.local_device`` never falls back to the CPU on its own.

Without CUDA and with no device named, ``local_device`` (and a mesh built
without a device) raises as ``resolve_device`` does; a named CPU device is
the CPU under gloo; inside a group joined with ``device='cpu'`` a mesh
built without naming a device runs where the group was joined (the
trainers' steps and metrics build theirs so).
"""

import pytest
import torch
import torch.distributed as dist

from ocflow_torch import parallel
from test_torch_ops import share_cores  # noqa: F401  (autouse)

NO_CUDA = "CUDA is not available; pass device='cpu'"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("call", [
    lambda: parallel.local_device(None),
    lambda: parallel.local_device(None, "gloo"),
    lambda: parallel.local_device("cuda", "gloo"),
    lambda: parallel.make_mesh(device=None),
    lambda: parallel.make_mesh((1,)),
])
def test_without_cuda_an_unnamed_device_raises(no_cuda, call):
    with pytest.raises(RuntimeError, match=NO_CUDA):
        call()


@pytest.mark.parametrize("backend", [None, "gloo"])
def test_a_named_cpu_is_the_cpu(no_cuda, backend):
    assert parallel.local_device("cpu", backend) == torch.device("cpu")
    mesh = parallel.make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.device) == (0, 1, torch.device("cpu"))


def test_a_group_joined_on_the_cpu_keeps_its_device(no_cuda, tmp_path):
    """One gloo process joined with ``device='cpu'``: meshes and metrics
    built without a device run on the CPU; once the group is gone an
    unnamed device raises again."""
    assert parallel.initialize(f"file://{tmp_path}/store", 1, 0, backend="gloo",
                               device="cpu") is False
    try:
        assert dist.is_initialized()
        assert parallel.local_device(None) == torch.device("cpu")
        assert parallel.make_mesh().device == torch.device("cpu")
        assert parallel.global_mean_metrics({"loss": 0.25}) == {"loss": 0.25}
    finally:
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match=NO_CUDA):
        parallel.local_device(None)
