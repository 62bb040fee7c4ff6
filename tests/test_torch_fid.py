"""FID, the Inception Score and InceptionV3 of the port (``metrics.fid``,
``metrics.inception``) against ``ocflow_tpu.metrics`` on the CPU.

The Inception weights: the port's seeded pytorch-fid network (1008
classes), every BatchNorm's scale set to sqrt(2) so the activations keep
their scale through its 94 ReLU convs (with flax's LeCun init and BatchNorm
at the identity the pool features shrink to ~3e-3 and the FID reads ~1e-6),
saved as a torch state_dict and converted to the ``.npz`` layout by both
packages' ``convert_torch_inception`` (equal key for key); the JAX network's
variables are that ``.npz`` unflattened (its ``init_inception`` runs an
eager flax ``init`` of 43 s here).

- Features and logits of 4 images at 299x299 within 1e-4 of max|JAX|.
- FID (8 against 8 images) and the Inception Score (8 images, 2 splits)
  within 1e-5 relative of the JAX package's on the same images (each FID's
  ``scipy.linalg.sqrtm`` of a 2048x2048 product takes ~20 s here).
- ``init_inception`` refuses an ``.npz`` with a tensor missing.

The evaluate CLI with ``--with_fid``: ``tests/test_torch_fid_cli.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocflow_torch.metrics import calculate_fid_given_imgs, inception_score, init_inception
from ocflow_torch.metrics.inception import InceptionV3, convert_torch_inception, seed_inception
from ocflow_tpu import metrics as jmetrics
from ocflow_tpu.metrics import inception as jinc
from test_torch_ops import share_cores  # noqa: F401  (autouse)

REL, FID_REL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The ``.npz`` (both converters agree on it) and the JAX net and
    variables."""
    tmp = tmp_path_factory.mktemp("inception")
    model = InceptionV3(num_classes=1008, fid_variant=True)
    seed_inception(model, torch.Generator().manual_seed(1))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.fill_(math.sqrt(2.0))
    torch.save(model.state_dict(), tmp / "fid.pth")
    convert_torch_inception(str(tmp / "fid.pth"), str(tmp / "port.npz"))
    jinc.convert_torch_inception(str(tmp / "fid.pth"), str(tmp / "jax.npz"))
    a, b = np.load(tmp / "port.npz"), np.load(tmp / "jax.npz")
    assert sorted(a.files) == sorted(b.files)
    assert all(np.array_equal(a[k], b[k]) for k in a.files)
    variables = jinc._unflatten({tuple(k.split("/")): a[k] for k in a.files})
    return str(tmp / "port.npz"), jinc.InceptionV3(num_classes=1008, fid_variant=True), \
        variables


def _images(n, seed, size=299):
    return np.random.default_rng(seed).uniform(-1, 1, (n, size, size, 3)).astype(np.float32)


def test_inception_features_match_jax(weights):
    path, jnet, variables = weights
    net = init_inception(weights_path=path)
    assert net.fc.out_features == 1008 and not net.training
    x = _images(4, 0)
    want = jax.jit(jnet.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    for g, w in zip(got, want, strict=True):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        print(f"inception output {tuple(w.shape)}: {err:.3e} of max|JAX|")
        assert err <= REL


def test_fid_and_inception_score_match_jax(weights):
    path, jnet, variables = weights
    net = init_inception(weights_path=path)
    apply = jax.jit(jnet.apply)
    a, b = _images(8, 1), _images(8, 2) * 0.5

    def port(i):
        with torch.no_grad():
            return net(torch.from_numpy(np.asarray(i)))

    fid = calculate_fid_given_imgs(a, b, lambda i: port(i)[0], batch_size=4)
    jfid = jmetrics.calculate_fid_given_imgs(a, b, lambda i: apply(variables, jnp.asarray(i))[0],
                                             batch_size=4)
    is_ = inception_score(a, lambda i: port(i)[1], batch_size=4, splits=2)
    jis = jmetrics.inception_score(a, lambda i: apply(variables, jnp.asarray(i))[1],
                                   batch_size=4, splits=2)
    print(f"FID {fid!r} (JAX {jfid!r}); IS {is_} (JAX {jis})")
    assert abs(fid - jfid) <= FID_REL * abs(jfid)
    for x, y in zip(is_, jis):
        assert abs(x - y) <= FID_REL * abs(y)


def test_init_inception_refuses_a_partial_file(weights, tmp_path):
    path = weights[0]
    data = dict(np.load(path))
    del data["params/InceptionC_0/BasicConv_3/Conv_0/kernel"]
    np.savez(tmp_path / "partial.npz", **data)
    with pytest.raises(ValueError, match="missing"):
        init_inception(weights_path=str(tmp_path / "partial.npz"))
